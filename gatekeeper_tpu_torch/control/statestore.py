"""Durable state snapshots: warm restart without a cluster re-scan.

Every restart used to be a full cold start — re-list the whole cluster,
re-encode the inventory, re-ingest and re-compile every template. The
reference Gatekeeper survives pod churn because its state is cheap to
rebuild; here the expensive-to-rebuild states are snapshotted to disk and
restored on boot:

  * ``vocab``     — the strtab intern table (ops/strtab.py). Restoring it
    keeps interned string ids — and therefore the vocab-capacity buckets
    that XLA program shapes depend on — stable across restarts, so the
    persistent compilation cache hits instead of recompiling.
  * ``library``   — the ingested template / constraint / mutator SOURCES
    (raw CRs). Re-ingested on boot so admission serves immediately
    instead of waiting for the first watch delivery; the controllers'
    level-triggered replay then dedupes via semantic-equal.
  * ``inventory`` — the audit's synced-inventory subtree (the driver's
    ``external`` data tree), the InventoryTracker's (uid, resourceVersion)
    state map, and the per-GVK watch-resume resourceVersions.
  * ``rows``      — the driver's encoded feature tensors per template
    kind (binary sidecar, numpy): adopted on the first warm audit when
    the candidate set still matches, skipping re-extraction entirely.

Snapshot files are versioned, checksummed, and written atomically
(write-to-temp + fsync + rename + directory fsync). Restore validates the
schema version and checksum; ANY corruption, staleness, or version skew
falls back to today's cold path — a bad snapshot must never crash-loop
the pod. The ``state.snapshot`` fault point (utils/faults.py) tears,
corrupts, or errors these files so the chaos suite can prove that.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Callable, Optional

from ..utils import faults
from . import metrics
from .logging import logger

log = logger("statestore")

SCHEMA_VERSION = 1

# a snapshot older than this is treated as unusable (the cluster has
# drifted too far for the resume RVs to mean anything; the 410-gap diff
# would re-list everything anyway, i.e. a cold start with extra steps)
DEFAULT_MAX_AGE_S = 7 * 24 * 3600.0


class SnapshotError(Exception):
    pass


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms without directory fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _apply_file_fault(mode: str, path: str) -> None:
    """Simulate on-disk damage for an armed state.snapshot fault."""
    if not os.path.exists(path):
        return
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(0, size // 2))
    elif mode == "corrupt":
        with open(path, "r+b") as f:
            f.seek(max(0, size // 2))
            b = f.read(1) or b"\x00"
            f.seek(max(0, size // 2))
            f.write(bytes([b[0] ^ 0xFF]))


class StateStore:
    """Versioned, checksummed, atomically-written snapshot files in one
    state directory (``--state-dir``). JSON sections ride `save`/`load`;
    binary payloads (encoded rows, the inventory tree) ride
    `save_blob`/`load_blob` with the checksum in a JSON sidecar."""

    def __init__(self, state_dir: str, max_age_s: float = DEFAULT_MAX_AGE_S):
        self.dir = state_dir
        self.max_age_s = max_age_s
        os.makedirs(state_dir, exist_ok=True)

    def path(self, section: str) -> str:
        return os.path.join(self.dir, f"{section}.snapshot.json")

    def aot_dir(self) -> str:
        """Where the AOT serialized-program store (ir/aot.py) lives:
        colocated under the state dir so one volume carries both the
        warm-restart snapshots and the warm-boot device programs (the
        full deserialize-and-go restart path). The store itself manages
        the per-(compute capability, device count, torch/CUDA/Triton
        versions) subdirs."""
        return os.path.join(self.dir, "aot")

    def blob_path(self, section: str) -> str:
        return os.path.join(self.dir, f"{section}.snapshot.blob")

    # ----------------------------------------------------------------- save

    def _write_atomic(self, path: str, data: bytes) -> None:
        # disk-pressure chaos: state.disk simulates the volume itself
        # failing under us — ENOSPC (full) or EIO (device error) — as
        # the kernel would raise it, so every save path exercises its
        # previous-snapshot-kept contract against real errno shapes
        flt = faults.consume("state.disk", path=path)
        if flt is not None:
            errno_ = 5 if (flt[1] or "enospc") == "eio" else 28
            raise OSError(errno_, os.strerror(errno_), path + ".tmp")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(self.dir)

    def _header(self, section: str, data: bytes,
                codec: Optional[str] = None) -> bytes:
        head = {
            "schema": SCHEMA_VERSION,
            "section": section,
            "created": time.time(),
            "sha256": hashlib.sha256(data).hexdigest(),
        }
        if codec:
            head["codec"] = codec
        return json.dumps(head).encode()

    def save(self, section: str, payload: Any) -> bool:
        """Atomically persist one JSON section as a header line (schema
        + checksum over the body bytes) followed by the body — one
        serialization pass, not a payload-inside-envelope double encode.
        Returns True when the file landed; a failed save leaves the
        previous snapshot intact (the temp file is never the live
        name)."""
        try:
            f = faults.consume("state.snapshot", op="save", section=section)
            if f is not None and f[0] in ("io-error", "raise", "error"):
                raise OSError(f"injected fault at state.snapshot ({f[0]})")
            body = json.dumps(payload, separators=(",", ":")).encode()
            self._write_atomic(self.path(section),
                               self._header(section, body) + b"\n" + body)
            if f is not None and f[0] in ("truncate", "corrupt"):
                _apply_file_fault(f[0], self.path(section))
        except Exception as e:
            metrics.report_snapshot("save", "error")
            log.error("snapshot save failed; previous snapshot kept",
                      details={"section": section, "error": str(e)})
            return False
        metrics.report_snapshot("save", "ok")
        metrics.report_snapshot_age(0.0)
        return True

    def save_blob(self, section: str, payload: Any,
                  codec: str = "pickle") -> bool:
        """Persist a serialized payload + checksum sidecar. The blob
        path exists for payloads JSON cannot carry efficiently: encoded
        feature tensors (numpy arrays; pickle, highest protocol) and
        the O(cluster) inventory tree (codec="marshal": ~2x faster
        C-native load, and restore latency IS the warm boot). marshal
        is OPT-IN because it silently flattens buffer objects like
        ndarrays to raw bytes — only callers whose payload is plain
        JSON-ish containers by construction may pass it; a cross-
        version marshal skew surfaces as a load error -> cold fallback.
        Trust note: the state dir is this pod's own volume, written
        only by this process — the checksum guards against corruption,
        not adversaries."""
        try:
            import marshal
            import pickle

            f = faults.consume("state.snapshot", op="save", section=section)
            if f is not None and f[0] in ("io-error", "raise", "error"):
                raise OSError(f"injected fault at state.snapshot ({f[0]})")
            if codec == "marshal":
                data = marshal.dumps(payload)
            else:
                codec = "pickle"
                data = pickle.dumps(payload,
                                    protocol=pickle.HIGHEST_PROTOCOL)
            self._write_atomic(self.blob_path(section), data)
            self._write_atomic(self.path(section),
                               self._header(section, data, codec=codec))
            if f is not None and f[0] in ("truncate", "corrupt"):
                _apply_file_fault(f[0], self.blob_path(section))
        except Exception as e:
            metrics.report_snapshot("save", "error")
            log.error("snapshot blob save failed; previous snapshot kept",
                      details={"section": section, "error": str(e)})
            return False
        metrics.report_snapshot("save", "ok")
        return True

    # ----------------------------------------------------------------- load

    def _read(self, section: str) -> Optional[tuple]:
        """(header, body_bytes) with schema/age validation; body is None
        for blob sidecars. Raises SnapshotError on anything that must
        route to the cold path."""
        path = self.path(section)
        f = faults.consume("state.snapshot", op="load", section=section)
        if f is not None:
            if f[0] in ("io-error", "raise", "error"):
                raise SnapshotError(
                    f"injected fault at state.snapshot ({f[0]})")
            _apply_file_fault(f[0], path)
            _apply_file_fault(f[0], self.blob_path(section))
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as fp:
                raw = fp.read()
        except OSError as e:
            raise SnapshotError(f"unreadable snapshot: {e}") from None
        head, sep, body = raw.partition(b"\n")
        try:
            header = json.loads(head)
        except ValueError as e:
            raise SnapshotError(f"corrupt snapshot header: {e}") from None
        if not isinstance(header, dict) or \
                header.get("schema") != SCHEMA_VERSION:
            raise SnapshotError(
                f"schema {header.get('schema') if isinstance(header, dict) else header!r} != {SCHEMA_VERSION}")
        # gklint: allow(clock) reason=created is a persisted epoch from another process lifetime; monotonic cannot span it
        age = time.time() - float(header.get("created") or 0)
        if self.max_age_s and age > self.max_age_s:
            raise SnapshotError(f"snapshot stale ({age:.0f}s old)")
        return header, (body if sep else None)

    def load(self, section: str) -> Optional[Any]:
        """Validated payload, or None when absent. Raises SnapshotError
        on corruption/staleness/skew — callers turn that into the cold
        path (and the `fallback` restore outcome), never a crash."""
        out = self._read(section)
        if out is None:
            return None
        header, body = out
        if body is None:
            raise SnapshotError("snapshot body missing")
        if hashlib.sha256(body).hexdigest() != header.get("sha256"):
            raise SnapshotError("checksum mismatch")
        try:
            return json.loads(body)
        except ValueError as e:
            raise SnapshotError(f"corrupt snapshot body: {e}") from None

    def load_blob(self, section: str) -> Optional[Any]:
        out = self._read(section)
        if out is None:
            return None
        header, _ = out
        path = self.blob_path(section)
        if not os.path.exists(path):
            raise SnapshotError("blob sidecar present but blob missing")
        with open(path, "rb") as fp:
            data = fp.read()
        if hashlib.sha256(data).hexdigest() != header.get("sha256"):
            raise SnapshotError("blob checksum mismatch")
        import marshal
        import pickle

        codec = header.get("codec") or "pickle"
        try:
            if codec == "marshal":
                return marshal.loads(data)
            return pickle.loads(data)
        except Exception as e:
            raise SnapshotError(f"blob unreadable: {e}") from None

    def age_s(self, section: str) -> Optional[float]:
        try:
            with open(self.path(section), "rb") as fp:
                head = fp.readline()
            # gklint: allow(clock) reason=persisted epoch stamp from a prior process lifetime; wall clock is the only shared base
            return time.time() - float(json.loads(head).get("created") or 0)
        except Exception:
            return None


class SnapshotManager:
    """Periodic + on-demand snapshotting over a StateStore.

    Providers are ``{section: callable -> payload | None}`` (None skips
    the section this round); ``blob_providers`` use the binary path.
    Snapshots run periodically (``--snapshot-interval``), on SIGTERM
    drain (Runtime.stop), and immediately on SIGHUP (save_now)."""

    def __init__(self, store: StateStore,
                 providers: dict[str, Callable[[], Any]],
                 blob_providers: Optional[dict] = None,
                 interval_s: float = 60.0,
                 blob_codecs: Optional[dict] = None):
        self.store = store
        self.providers = providers
        self.blob_providers = blob_providers or {}
        # per-section blob codec overrides (e.g. inventory -> marshal;
        # see save_blob for why marshal is opt-in)
        self.blob_codecs = blob_codecs or {}
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._lock = threading.Lock()  # one snapshot pass at a time
        self._thread: Optional[threading.Thread] = None
        self.last_saved: Optional[float] = None

    def add_provider(self, section: str, fn: Callable[[], Any],
                     blob: bool = False,
                     codec: Optional[str] = None) -> None:
        """Register a section after construction (subsystems built
        later than the manager — e.g. the sharded-audit plane — attach
        their sections here instead of threading providers through
        Runtime.__init__ ordering)."""
        if blob:
            self.blob_providers[section] = fn
            if codec:
                self.blob_codecs[section] = codec
        else:
            self.providers[section] = fn

    def start(self) -> None:
        if self.interval_s <= 0:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="snapshots", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()

    def kick(self) -> None:
        """Request an immediate snapshot (SIGHUP handler); safe from a
        signal context — the loop thread does the work."""
        self._kick.set()

    def save_now(self) -> int:
        """Run one snapshot pass synchronously; returns sections saved.
        Sections are captured one by one — vocab is captured LAST, after
        every other section INCLUDING the blobs (the encoded rows hold
        interned ids): the intern table is append-only, so a later
        capture is always a superset of whatever ids earlier sections
        reference; captured any earlier, rows re-extracted by a
        concurrent audit could reference ids the persisted vocab lacks
        and silently decode wrong after restore."""
        saved = 0

        def one(name, fn, save):
            try:
                payload = fn()
            except Exception as e:
                metrics.report_snapshot("save", "error")
                log.error("snapshot provider failed",
                          details={"section": name, "error": str(e)})
                return 0
            if payload is None:
                return 0
            return 1 if save(name, payload) else 0

        with self._lock:
            for name in sorted(self.providers):
                if name == "vocab":
                    continue
                saved += one(name, self.providers[name], self.store.save)
            for name in sorted(self.blob_providers):
                saved += one(
                    name, self.blob_providers[name],
                    lambda n, p: self.store.save_blob(
                        n, p, codec=self.blob_codecs.get(n, "pickle")))
            if "vocab" in self.providers:
                saved += one("vocab", self.providers["vocab"],
                             self.store.save)
        if saved:
            self.last_saved = time.monotonic()
            metrics.report_snapshot_age(0.0)
            log.info("state snapshot saved",
                     details={"sections": saved, "dir": self.store.dir})
        return saved

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._kick.wait(self.interval_s)
            if self._stop.is_set():
                return
            self._kick.clear()
            try:
                self.save_now()
            except Exception as e:  # the snapshot loop must never die
                log.error("snapshot pass failed", details=str(e))
            if self.last_saved is not None:
                metrics.report_snapshot_age(
                    time.monotonic() - self.last_saved)


def restore_section(store: StateStore, section: str,
                    apply: Callable[[Any], Any],
                    blob: bool = False) -> bool:
    """Shared restore protocol: load one section, hand it to `apply`,
    and map every failure mode onto the restore metric — `ok` when
    applied, `missing` when no snapshot exists, `fallback` when the
    snapshot is corrupt/stale/unusable (the caller proceeds down the
    cold path; never raises)."""
    try:
        payload = store.load_blob(section) if blob else store.load(section)
    except SnapshotError as e:
        metrics.report_snapshot("restore", "fallback")
        log.warning("snapshot unusable; falling back to cold start",
                    details={"section": section, "error": str(e)})
        return False
    except Exception as e:
        metrics.report_snapshot("restore", "fallback")
        log.error("snapshot restore failed; falling back to cold start",
                  details={"section": section, "error": str(e)})
        return False
    if payload is None:
        metrics.report_snapshot("restore", "missing")
        return False
    try:
        apply(payload)
    except Exception as e:
        metrics.report_snapshot("restore", "fallback")
        log.error("snapshot apply failed; falling back to cold start",
                  details={"section": section, "error": str(e)})
        return False
    metrics.report_snapshot("restore", "ok")
    age = store.age_s(section)
    if age is not None:
        metrics.report_snapshot_age(age)
    log.info("snapshot restored", details={"section": section})
    return True
