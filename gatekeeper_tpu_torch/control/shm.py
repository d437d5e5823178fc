"""Shared-memory admission backplane rings.

The saturation scrape proved the serving plane edge-bound: device
duty cycle 0.07 with micro-batches sealing on max_wait at fill 0.013
while the engine sustains ~6k batched reviews/s per chip. Part of the
remaining edge cost is pure byte motion — every review was framed and
copied twice across the Unix-socket backplane (frontend sendall ->
kernel -> engine recv -> payload slice). This module removes the
payload from the socket entirely:

    frontend process                       engine process
    ┌───────────────────┐   descriptor    ┌──────────────────┐
    │ HTTP accept/parse │ ──(rid,off,len)─►│ memoryview slice │
    │ body -> REQ ring ─┼───── UDS ───────┼─► jsonio.loads   │
    │ REPLY ring -> HTTP│◄──(rid,off,len)──┼── envelope bytes │
    └───────────────────┘                 └──────────────────┘
            └────────── mmap'd shared memory ──────────┘

Each frontend OWNS one request ring and one reply ring
(`multiprocessing.shared_memory`, i.e. /dev/shm): review bytes are
written into the request ring at accept time, the Q frame shrinks to a
(rid, offset, length) descriptor, and the engine parses the review
straight out of the mapped ring — zero payload copies across the
backplane. Responses ride the reply ring the same way (the engine is
that ring's writer). The SOCKET stays the ordering / wakeup / failure
channel; the rings carry only payload bytes.

Concurrency model (deliberately asymmetric — it is what makes the ring
safe without cross-process locks):

  * the WRITER owns all allocation state (head/tail are plain Python
    ints in the writing process, guarded by a process-local lock);
  * the READER communicates exactly one thing back: a one-byte DONE
    flag per record (single-byte stores are atomic; a stale read just
    delays slot reuse by one reclaim pass);
  * records are reclaimed in FIFO allocation order by scanning DONE
    flags from the tail, so out-of-order release (engine pool threads,
    HTTP response threads) is absorbed with bounded head-of-line
    blocking rather than corruption;
  * when a burst outruns the reader (no contiguous space under the
    watermark), `alloc` returns None and the caller falls back to the
    inline-payload frame — the accept loop NEVER blocks on ring space.

Lifecycle rides the frontend supervisor contract: deterministic names
(`gk-bp-<supervisor pid>-w<slot>-{q,r}`) are created at frontend spawn,
unlinked on clean exit, and swept by the supervisor before a respawn
(a SIGKILLed frontend cannot unlink its own segments). The engine
attaches on the H-frame handshake, answers an A-frame ack (descriptors
are only sent after the ack), and detaches when the connection dies —
failing that frontend's in-flight requests exactly as before.
"""

from __future__ import annotations

import os
import struct
import threading
from collections import deque
from typing import Optional

try:  # the container may lack /dev/shm or the module (exotic platforms)
    from multiprocessing import shared_memory as _shm
except ImportError:  # pragma: no cover - stdlib module, but stay honest
    _shm = None

# record header: u32 payload length | u8 state | 3 pad. Only the state
# byte is cross-process (reader -> writer); the length is a debugging
# aid. Payload follows the header, 8-byte aligned.
REC_HDR = 8
_LEN = struct.Struct("!I")
ST_BUSY = 1
ST_DONE = 2

# one record may claim at most this fraction of the ring: a single
# monster review must not evict the whole burst into the inline path
MAX_ITEM_FRACTION = 0.25
# allocation watermark: keep this much headroom so release lag under a
# burst degrades into occasional inline fallbacks, not boundary thrash
WATERMARK = 0.9375


def supported() -> bool:
    return _shm is not None


def _align(n: int) -> int:
    return (n + 7) & ~7


def create(name: str, size: int):
    """Create (replacing any stale same-named segment) a ring segment."""
    if _shm is None:
        raise OSError("multiprocessing.shared_memory unavailable")
    unlink(name)
    return _shm.SharedMemory(name=name, create=True, size=size)


def attach(name: str):
    if _shm is None:
        raise OSError("multiprocessing.shared_memory unavailable")
    seg = _shm.SharedMemory(name=name)
    # CPython registers segments with the resource tracker on ATTACH
    # too (bpo-39959): without this unregister, an attaching process's
    # exit would WARN about — and worse, unlink — rings its peer still
    # owns. The creator's registration is the one that should stand.
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(seg._name, "shared_memory")
    except Exception:
        pass
    return seg


def unlink(name: str) -> None:
    """Remove a segment by name, from any process; missing is fine
    (the supervisor sweeps a SIGKILLed frontend's rings this way)."""
    if _shm is None:
        return
    try:
        seg = _shm.SharedMemory(name=name)
    except (OSError, ValueError):
        return
    try:
        seg.unlink()
    except OSError:
        pass
    finally:
        _close_quiet(seg)


# segments that could not unmap because a slice was still exported
# (an in-flight response mid-send at teardown): parked here so their
# finalizer never re-raises from GC; retried on the next park
_GRAVEYARD: list = []


def _close_quiet(seg) -> None:
    """Close a segment tolerating exported memoryviews: a slice still
    held by an in-flight response keeps the mapping alive until GC —
    parking a page beats raising into a teardown path."""
    for parked in _GRAVEYARD[:]:
        try:
            parked.close()
            _GRAVEYARD.remove(parked)
        except (BufferError, OSError):
            pass
    try:
        seg.close()
    except BufferError:
        _GRAVEYARD.append(seg)
    except OSError:
        pass


class RingWriter:
    """The allocating side of one ring (frontend for the request ring,
    engine for the reply ring). All state process-local except payload
    bytes and the per-record DONE flags."""

    def __init__(self, seg):
        self.seg = seg
        self.buf = seg.buf
        self.size = len(seg.buf)
        self.max_item = int(self.size * MAX_ITEM_FRACTION) - REC_HDR
        self._limit = int(self.size * WATERMARK)
        self._lock = threading.Lock()
        self._head = 0  # virtual (monotonic) offsets; phys = v % size
        self._tail = 0
        # FIFO of (virt_off, padded_len, hdr_phys_or_None): None marks a
        # wrap gap (the unusable remainder before a wrapped record)
        self._recs: deque = deque()
        self.allocs = 0
        self.fallbacks = 0

    # -- allocation ---------------------------------------------------

    def _reclaim_locked(self) -> None:
        while self._recs:
            _virt, plen, hdr = self._recs[0]
            if hdr is not None and self.buf[hdr + 4] != ST_DONE:
                break
            self._recs.popleft()
            self._tail += plen

    def append(self, data) -> Optional[int]:
        """Write one payload; returns its physical offset for the
        descriptor, or None when the ring is out of space / the item
        exceeds the per-item cap (caller sends the inline frame)."""
        n = len(data)
        need = _align(REC_HDR + n)
        if n > self.max_item:
            with self._lock:
                self.fallbacks += 1
            return None
        with self._lock:
            self._reclaim_locked()
            used = self._head - self._tail
            phys = self._head % self.size
            gap = 0
            if phys + need > self.size:
                gap = self.size - phys  # record never straddles the end
                phys = 0
            if used + gap + need > self._limit:
                self.fallbacks += 1
                return None
            if gap:
                self._recs.append((self._head, gap, None))
                self._head += gap
            hdr = phys
            _LEN.pack_into(self.buf, hdr, n)
            self.buf[hdr + 4] = ST_BUSY
            self._recs.append((self._head, need, hdr))
            self._head += need
            self.allocs += 1
        off = hdr + REC_HDR
        self.buf[off:off + n] = data
        return off

    def cancel(self, off: int) -> None:
        """Release a slot the reader will never consume (send failed,
        waiter abandoned, connection died): marks it DONE so reclaim
        can pass. The reader may still be parsing a cancelled slot on a
        wedged-peer race; a garbled parse answers 400 to a request id
        nobody waits on — verdicts are unaffected."""
        self.buf[off - REC_HDR + 4] = ST_DONE

    def fail_all(self) -> None:
        """Mark every outstanding record DONE (the attached reader is
        gone — connection loss already failed its in-flight waiters)."""
        with self._lock:
            for _virt, _plen, hdr in self._recs:
                if hdr is not None:
                    self.buf[hdr + 4] = ST_DONE
            self._reclaim_locked()

    # -- introspection ------------------------------------------------

    def used_fraction(self) -> float:
        with self._lock:
            self._reclaim_locked()
            return (self._head - self._tail) / self.size

    def close(self) -> None:
        self.buf = None
        _close_quiet(self.seg)


class RingReader:
    """The consuming side: descriptor -> zero-copy memoryview, then one
    state-byte release. No allocation state lives here."""

    def __init__(self, seg):
        self.seg = seg
        self._mv = memoryview(seg.buf)

    def view(self, off: int, n: int) -> memoryview:
        return self._mv[off:off + n]

    def release(self, off: int) -> None:
        self.seg.buf[off - REC_HDR + 4] = ST_DONE

    def close(self) -> None:
        try:
            self._mv.release()
        except BufferError:
            pass
        _close_quiet(self.seg)


class RingSlice:
    """A response payload living in a reply ring: bytes-like enough for
    the HTTP send path (len / buffer / bytes()), released back to the
    ring exactly once, after the final send (or on error)."""

    __slots__ = ("mv", "_reader", "_off", "_released")

    def __init__(self, reader: RingReader, off: int, n: int):
        self.mv = reader.view(off, n)
        self._reader = reader
        self._off = off
        self._released = False

    def __len__(self) -> int:
        return len(self.mv)

    def __bytes__(self) -> bytes:
        return bytes(self.mv)

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        mv, self.mv = self.mv, None
        try:
            mv.release()
        except BufferError:  # pragma: no cover - defensive
            pass
        try:
            self._reader.release(self._off)
        except (TypeError, ValueError):  # ring torn down first
            pass


class ClientRings:
    """The frontend-owned ring pair for one engine connection: this
    process WRITES the request ring and READS the reply ring."""

    def __init__(self, prefix: str, size_bytes: int):
        self.prefix = prefix
        self.qname = f"{prefix}-q"
        self.rname = f"{prefix}-r"
        qseg = create(self.qname, size_bytes)
        try:
            rseg = create(self.rname, size_bytes)
        except OSError:
            _close_quiet(qseg)
            unlink(self.qname)
            raise
        self.req = RingWriter(qseg)
        self.reply = RingReader(rseg)

    def hello(self) -> dict:
        return {"q": self.qname, "r": self.rname}

    def reply_slice(self, off: int, n: int) -> RingSlice:
        return RingSlice(self.reply, off, n)

    def on_disconnect(self) -> None:
        """Engine gone: every in-flight request slot is dead (the
        waiters were failed); free them so the ring cannot silt up."""
        self.req.fail_all()

    def close(self, unlink_segments: bool = True) -> None:
        if unlink_segments:
            unlink(self.qname)
            unlink(self.rname)
        self.req.close()
        self.reply.close()


class EngineRings:
    """The engine-attached view of one frontend's ring pair: READS the
    request ring, WRITES the reply ring."""

    def __init__(self, names: dict):
        qseg = attach(str(names["q"]))
        try:
            rseg = attach(str(names["r"]))
        except OSError:
            _close_quiet(qseg)
            raise
        self.req = RingReader(qseg)
        self.reply = RingWriter(rseg)

    def close(self) -> None:
        self.req.close()
        self.reply.close()


def sweep_stale(prefix: str) -> None:
    """Unlink any ring segments under `prefix` (supervisor respawn /
    shutdown path: a SIGKILLed frontend leaves its segments behind)."""
    for suffix in ("-q", "-r"):
        unlink(prefix + suffix)


# ------------------------------------------------------------ chaos hooks


_SHM_DIR = "/dev/shm"


def list_segments(prefix: str = "") -> list[str]:
    """Names of live /dev/shm segments starting with `prefix` (the
    chaos verifier's leak check: after a schedule + teardown, no
    gk-bp-* segment may remain). Empty where /dev/shm is absent."""
    try:
        names = os.listdir(_SHM_DIR)
    except OSError:
        return []
    return sorted(n for n in names if n.startswith(prefix))


def corrupt_segment(name: str, offset: int = 0,
                    pattern: bytes = b"\xde\xad\xbe\xef") -> bool:
    """Chaos action: stamp `pattern` into a live segment at `offset`
    without the owner's locks — a torn/corrupted record the reader
    must survive (parse failure -> 400 / inline retry, never a smeared
    verdict). Returns False when the segment does not exist."""
    if _shm is None:
        return False
    try:
        seg = _shm.SharedMemory(name=name)
    except (OSError, ValueError):
        return False
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(seg._name, "shared_memory")
    except Exception:
        pass
    try:
        end = min(len(seg.buf), offset + len(pattern))
        if end > offset:
            seg.buf[offset:end] = pattern[: end - offset]
        return True
    finally:
        _close_quiet(seg)
