"""The program store: K2's compiled variants kept across processes.

The JAX package's ir/aot.py, for the port. A restart used to pay every
template's Triton compiles again (config 6's 16 kinds: about 26 s in a
fresh process). This module removes that:

  * ``AotStore`` — an on-disk store of K2's compiled variants, keyed by
    (program fingerprint, tag + static config, argument signature) under
    a directory per platform (compute capability, device count, torch,
    CUDA and Triton versions). A variant is a *group of files*: its
    generated Triton source and the group Triton's own file cache keeps
    for the compiled kernel (the cubin and its metadata JSON, under the
    compiled kernel's hash). A warm boot installs the group where
    Triton's cache manager looks, and Triton loads it in milliseconds
    instead of compiling. The store also persists the driver's *warm
    sweep signatures* per program fingerprint, so a restarted process
    knows, before its first sweep, which shapes load and go, and
    dispatches them on the device at once.
  * The acquisition (kernels/clause_triton.py ``launch``): a launch whose
    variant is not yet in the JIT function's in-memory cache takes it
    from the store (source "aot"), or finds it in Triton's own disk
    cache ("cache"), or compiles it ("fresh") and saves it; a failure
    counts "error".

The store is best-effort: a directory that cannot be written disables
it (logged) and serving goes on with Triton's own cache. Entries are
trusted only when the RESOLVED program fingerprint matches (interned
string ids are embedded in the program constants, so a vocabulary
mismatch changes the fingerprint and safely misses).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
from collections import deque
from typing import Any, Optional

log = logging.getLogger("gatekeeper_tpu_torch.ir.aot")


class WouldCompile(Exception):
    """Raised by the K2 acquisition instead of compiling while a
    no_inline_compile() scope is active: the caller promised this
    dispatch would load and go (a warm-boot-adopted sweep signature), so
    a store miss must bounce back to the host-fallback/background-warm
    path rather than stall the serving thread on Triton."""


_guard = threading.local()


class no_inline_compile:
    """Context manager: within the scope, a K2 launch that cannot answer
    from its in-memory or stored variants raises WouldCompile instead of
    compiling inline. Thread-local (background warm threads keep
    compiling freely)."""

    def __enter__(self):
        self._prev = getattr(_guard, "active", False)
        _guard.active = True
        return self

    def __exit__(self, *exc):
        _guard.active = self._prev
        return False


def inline_compile_forbidden() -> bool:
    """Whether the calling thread is inside a no_inline_compile scope."""
    return getattr(_guard, "active", False)


# global fresh/cache/aot counters, readable by tests and bench runs that
# span several drivers in one process (the per-store stats reset with
# the store object)
COMPILE_COUNTS = {"aot": 0, "cache": 0, "fresh": 0, "error": 0}
_counts_lock = threading.Lock()


def _report_compile(source: str, outcome: str, seconds: float) -> None:
    with _counts_lock:
        COMPILE_COUNTS[source if outcome == "ok" else "error"] = \
            COMPILE_COUNTS.get(source if outcome == "ok" else "error",
                               0) + 1
    try:
        from ..control.metrics import report_compile

        report_compile(source, outcome, seconds)
    except Exception:  # metrics backend optional in embedders
        pass


def _jsonable(x):
    if isinstance(x, tuple):
        return [_jsonable(v) for v in x]
    return x


def _detuple(x):
    if isinstance(x, list):
        return tuple(_detuple(v) for v in x)
    return x


def program_fingerprint(program: Any, kind: str = "") -> str:
    """Fingerprint of a RESOLVED Program (resolve_consts already ran):
    interned string/row/number ids are embedded in the constants, so two
    processes only share a fingerprint when their vocab assignments for
    the program's constants match — exactly the condition under which a
    stored kernel is reusable."""
    body = repr(program).encode()
    return hashlib.sha256(kind.encode() + b"\x00" + body).hexdigest()


class AotStore:
    """Disk store of K2's compiled variants + warm sweep signatures.

    Layout (under ``set_dir``'s path):

        <dir>/<platform>/
            manifest.jsonl          append-only: program entries + sigs
            <key>/                  one variant's group of files

    The platform subdir keys the whole store by what a compiled kernel
    cannot cross (_platform_key)."""

    MANIFEST = "manifest.jsonl"
    # per-fingerprint warm-sig cap: sigs are tiny, but a churn-heavy
    # deployment must not grow them forever (oldest dropped first)
    MAX_SIGS_PER_FP = 256

    def __init__(self, path: Optional[str] = None):
        self.dir: Optional[str] = None
        self._lock = threading.Lock()
        # fingerprint -> insertion-ordered {sig: None} (dict-as-set)
        self._sigs: dict[str, dict] = {}
        # fingerprint -> list of {"tag","static","asig","file"}
        self._entries: dict[str, list] = {}
        self._known_files: set = set()
        # global FIFO of (fingerprint, file) for bounded eviction:
        # template edits change the fingerprint, so without a cap stale
        # programs' groups would accumulate on the volume forever;
        # oldest-first eviction retires them
        self._order: list = []
        self.max_programs = int(os.environ.get(
            "GATEKEEPER_TPU_AOT_MAX_PROGRAMS", "512"))
        self.stats = {"aot": 0, "cache": 0, "fresh": 0, "error": 0,
                      "aot_seconds": 0.0, "compile_seconds": 0.0}
        # per-kind recent compile events
        self._events: dict[str, deque] = {}
        if path:
            self.set_dir(path)

    # ------------------------------------------------------------ config

    @property
    def enabled(self) -> bool:
        return self.dir is not None

    def _platform_key(self) -> str:
        """What a compiled kernel cannot cross: the card's compute
        capability, the device count, and the torch, CUDA and Triton
        versions (on a host without a card, the CPU and torch)."""
        import torch

        if not torch.cuda.is_available():
            return f"cpu-torch{torch.__version__}"
        import triton

        major, minor = torch.cuda.get_device_capability()
        return (f"cuda-sm{major}{minor}-d{torch.cuda.device_count()}"
                f"-torch{torch.__version__}-cuda{torch.version.cuda}"
                f"-triton{triton.__version__}")

    def set_dir(self, path: str) -> bool:
        """Point the store at a directory (idempotent); loads the
        manifest. Returns False (store stays disabled) when the
        directory is unusable — a read-only volume must degrade to
        Triton's own cache, not break serving."""
        try:
            full = os.path.join(path, self._platform_key())
            os.makedirs(full, exist_ok=True)
            # probe writability once: os.makedirs succeeds on an
            # existing dir of a read-only volume
            probe = os.path.join(full, f".probe.{os.getpid()}")
            with open(probe, "w") as f:
                f.write("")
            os.unlink(probe)
        except OSError as e:
            log.warning("AOT program cache disabled (dir unusable): "
                        "%s: %s", path, e)
            return False
        with self._lock:
            self.dir = full
            self._load_manifest()
        log.info("AOT program cache at %s: %d stored programs, "
                 "%d warm sweep signatures",
                 full, sum(len(v) for v in self._entries.values()),
                 sum(len(v) for v in self._sigs.values()))
        try:
            from ..control.metrics import report_aot_store

            report_aot_store(True, self.programs_count())
        except Exception:  # metrics backend optional in embedders
            pass
        return True

    def programs_count(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._entries.values())

    # ---------------------------------------------------------- manifest

    def _load_manifest(self) -> None:
        self._sigs.clear()
        self._entries.clear()
        self._known_files.clear()
        self._order.clear()
        path = os.path.join(self.dir, self.MANIFEST)
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            return
        dropped = 0
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                fp = rec["fp"]
                if rec.get("t") == "sig":
                    self._sigs.setdefault(
                        fp, {})[_detuple(rec["sig"])] = None
                elif rec.get("t") == "entry":
                    fn = rec["file"]
                    if fn in self._known_files:
                        continue
                    # an entry whose group vanished (evicted by another
                    # process, manual cleanup) is dead weight
                    if not os.path.exists(os.path.join(self.dir, fn)):
                        dropped += 1
                        continue
                    self._known_files.add(fn)
                    self._entries.setdefault(fp, []).append({
                        "tag": rec["tag"],
                        "static": _detuple(rec["static"]),
                        "asig": _detuple(rec["asig"]),
                        "file": fn,
                    })
                    self._order.append((fp, fn))
            except Exception:
                continue  # torn tail line of a crashed writer
        self._evict_over_cap()
        live = len(self._order) + sum(len(v) for v in self._sigs.values())
        # the manifest is append-only between boots: compact it when
        # dead lines (duplicate sigs, evicted/vanished entries) dominate
        if dropped or len(lines) > 2 * live + 64:
            self._compact()

    def _evict_over_cap(self) -> None:
        """Retire oldest stored programs beyond max_programs (FIFO:
        stale fingerprints from template edits age out first). Caller
        holds the lock (or is single-threaded in set_dir)."""
        evicted = False
        while self.max_programs > 0 and len(self._order) > \
                self.max_programs:
            fp, fn = self._order.pop(0)
            self._known_files.discard(fn)
            ents = self._entries.get(fp, [])
            self._entries[fp] = [e for e in ents if e["file"] != fn]
            if not self._entries[fp]:
                self._entries.pop(fp, None)
                self._sigs.pop(fp, None)
            shutil.rmtree(os.path.join(self.dir, fn), ignore_errors=True)
            evicted = True
        if evicted:
            self._compact()

    def _compact(self) -> None:
        """Rewrite the manifest from in-memory state (atomic): drops
        evicted/vanished entries and duplicate sig lines so the
        append-only file can't grow without bound across boots."""
        path = os.path.join(self.dir, self.MANIFEST)
        tmp = path + f".tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                for fp, sigs in self._sigs.items():
                    for sig in sigs:
                        f.write(json.dumps(
                            {"t": "sig", "fp": fp,
                             "sig": _jsonable(sig)},
                            separators=(",", ":")) + "\n")
                for fp, fn in self._order:
                    ent = next((e for e in self._entries.get(fp, ())
                                if e["file"] == fn), None)
                    if ent is None:
                        continue
                    f.write(json.dumps(
                        {"t": "entry", "fp": fp, "tag": ent["tag"],
                         "static": _jsonable(ent["static"]),
                         "asig": _jsonable(ent["asig"]),
                         "file": fn}, separators=(",", ":")) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError as e:
            log.warning("AOT manifest compaction failed: %s", e)
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _append_manifest(self, rec: dict) -> None:
        try:
            with open(os.path.join(self.dir, self.MANIFEST), "a") as f:
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
                f.flush()
        except OSError as e:
            log.warning("AOT manifest append failed: %s", e)

    # ------------------------------------------------------- sweep sigs

    def record_sig(self, fingerprint: str, sig: tuple) -> None:
        """Persist one warm driver sweep signature: a later boot marks
        this (fingerprint, shape) warm before its first sweep and
        dispatches on the device (load and go) immediately."""
        if not self.enabled:
            return
        with self._lock:
            have = self._sigs.setdefault(fingerprint, {})
            if sig in have:
                return
            have[sig] = None
            while len(have) > self.MAX_SIGS_PER_FP:
                have.pop(next(iter(have)))
            self._append_manifest(
                {"t": "sig", "fp": fingerprint, "sig": _jsonable(sig)})

    def sigs_for(self, fingerprint: str) -> set:
        with self._lock:
            return set(self._sigs.get(fingerprint, ()))

    def entries_for(self, fingerprint: str) -> list:
        with self._lock:
            return list(self._entries.get(fingerprint, ()))

    # ----------------------------------------------------------- groups

    def entry_key(self, fingerprint: str, tag: str, static: tuple,
                  asig: tuple) -> str:
        h = hashlib.sha256(repr((fingerprint, tag, static,
                                 asig)).encode()).hexdigest()
        return h[:40]

    def has(self, key: str) -> bool:
        with self._lock:
            return key in self._known_files

    def load(self, key: str) -> Optional[dict]:
        """One stored group as {file name: bytes}, or None. Any failure
        (missing, unreadable) is a miss."""
        if not self.enabled:
            return None
        path = os.path.join(self.dir, key)
        try:
            names = os.listdir(path)
            out = {}
            for name in names:
                with open(os.path.join(path, name), "rb") as f:
                    out[name] = f.read()
        except FileNotFoundError:
            return None
        except OSError as e:
            log.warning("AOT entry %s unreadable (recompiling): %s: %s",
                        key, type(e).__name__, e)
            return None
        return out

    def save(self, key: str, files: dict, fingerprint: str, tag: str,
             static: tuple, asig: tuple) -> bool:
        """Persist one complete group ({file name: bytes}) atomically: it
        is written under a temporary name and renamed into place, so a
        reader sees the whole group or none of it."""
        if not self.enabled or not files:
            return False
        path = os.path.join(self.dir, key)
        if not os.path.isdir(path):
            tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
            try:
                os.makedirs(tmp)
                for name, data in files.items():
                    with open(os.path.join(tmp, name), "wb") as f:
                        f.write(data)
                        f.flush()
                        os.fsync(f.fileno())
                os.rename(tmp, path)
            except OSError as e:
                shutil.rmtree(tmp, ignore_errors=True)
                if not os.path.isdir(path):  # not a concurrent writer's
                    log.warning("AOT entry write failed: %s", e)
                    return False
        with self._lock:
            if key not in self._known_files:
                self._known_files.add(key)
                self._entries.setdefault(fingerprint, []).append({
                    "tag": tag, "static": static, "asig": asig,
                    "file": key})
                self._order.append((fingerprint, key))
                self._append_manifest({
                    "t": "entry", "fp": fingerprint, "tag": tag,
                    "static": _jsonable(static),
                    "asig": _jsonable(asig), "file": key})
                self._evict_over_cap()
        return True

    # ---------------------------------------------------- observability

    def note(self, source: str, seconds: float, kind: str = "",
             tag: str = "", key: tuple = (),
             outcome: str = "ok") -> None:
        with self._lock:
            if outcome == "ok":
                self.stats[source] = self.stats.get(source, 0) + 1
                sec_key = ("aot_seconds" if source == "aot"
                           else "compile_seconds")
                self.stats[sec_key] = self.stats.get(sec_key, 0.0) \
                    + seconds
            else:
                self.stats["error"] = self.stats.get("error", 0) + 1
            ev = self._events.setdefault(kind or "?", deque(maxlen=8))
            ev.append({"tag": tag, "source": source,
                       "seconds": round(seconds, 3),
                       "outcome": outcome,
                       "bucket_key": repr(key)})
        _report_compile(source, outcome, seconds)

    def events_for(self, kind: str) -> list:
        with self._lock:
            return list(self._events.get(kind, ()))

    def stats_snapshot(self) -> dict:
        with self._lock:
            out = dict(self.stats)
        out["enabled"] = self.enabled
        out["dir"] = self.dir
        return out


def triton_cache_dir() -> str:
    """The directory of Triton's on-disk kernel cache, read as Triton
    reads it at each compile: TRITON_CACHE_DIR, else
    $TRITON_HOME/.triton/cache (TRITON_HOME defaults to the home
    directory)."""
    return os.environ.get("TRITON_CACHE_DIR", "").strip() or os.path.join(
        os.environ.get("TRITON_HOME", os.path.expanduser("~")),
        ".triton", "cache")


def enable_compile_cache() -> bool:
    """Whether Triton's on-disk kernel cache is usable (the JAX package's
    enable_compile_cache points JAX at its persistent compilation cache;
    Triton keeps one of its own by default, so here it is only checked,
    not configured or created). Failure degrades to recompile-every-boot;
    it is logged at WARNING with the attempted dir and exported as the
    `gatekeeper_tpu_compile_cache_enabled` gauge, never raised."""
    path = triton_cache_dir()
    probe = path
    while not os.path.isdir(probe):  # Triton creates it at first use
        parent = os.path.dirname(probe)
        if parent == probe:
            break
        probe = parent
    ok = os.access(probe, os.W_OK | os.X_OK)
    if not ok:
        log.warning("Triton kernel cache unusable (every boot "
                    "recompiles): %s is not writable", path)
    try:
        from ..control.metrics import report_compile_cache

        report_compile_cache(ok)
    except Exception:  # metrics backend optional in embedders
        pass
    return ok
