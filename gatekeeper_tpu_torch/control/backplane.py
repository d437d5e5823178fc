"""Admission serving plane: pre-fork HTTP frontends over a shared
batching backplane.

The single-process webhook frontend is GIL-bound: BENCH_r05 config 5
showed the engine sustaining ~6,000 batched reviews/s while one Python
HTTP frontend delivered ~500 req/s. The reference line scales its Go
webhook by replicating pods behind a Service; the TPU-native analogue
must keep ONE device-owning engine so micro-batches stay full. So the
plane splits:

    API server ──TLS──► frontend 0 ─┐
    API server ──TLS──► frontend 1 ─┼─UDS─► engine (JAX + Client +
    API server ──TLS──► frontend N ─┘        MicroBatcher + handlers)

N pre-forked frontend processes (one GIL each) bind the webhook port
with SO_REUSEPORT and do ONLY accept / TLS / header parse; the request
body rides the backplane as opaque bytes — frontends never JSON-decode
a review. The engine decodes once, submits into the SHARED MicroBatcher
(requests from all workers coalesce into the same device micro-batch:
cross-worker batching is the point — N trickles become one full batch),
and answers with preserialized envelope bytes the frontend writes
straight to its HTTP socket.

Wire protocol, length-prefixed frames over a Unix domain socket
(multiplexed: many in-flight requests per frontend connection):

    frame    := u32be payload_len, payload
    payload  := type(1 byte) + body
    'Q'      := id u32be, timeout_s f64be (0 = absent), tflags u8,
                [tflags&1: trace_id 16 bytes, t_recv f64be,
                t_fwd f64be], path_len u16be, path bytes,
                [tflags&2: ring_off u32be, ring_len u32be — the review
                lives in the frontend's request RING; else:] review
                bytes                               (frontend -> engine)
    'R'      := id u32be, http_status u16be, body   (engine -> frontend)
    'r'      := id u32be, http_status u16be, ring_off u32be,
                ring_len u32be (response bytes live in the frontend's
                reply RING)                         (engine -> frontend)
    'H'      := hello JSON {"worker": id, "rings": {"q":..., "r":...}}
                                                    (frontend -> engine)
    'A'      := ack JSON {"rings": bool} — whether the engine attached
                the hello's rings; descriptors flow only after a true
                ack                                 (engine -> frontend)
    'S'      := stats JSON (aggregated forward-latency histogram delta
                + failure-stance answer count + per-stage span-duration
                histogram deltas for sampled requests) (frontend -> engine)
    'L'      := id u32be, library-op JSON           (primary -> engine)
    'M'      := id u32be (stats poll; engine answers R with its
                relayed-metrics snapshot JSON)      (primary -> engine)
    'B'      := id u32be, timeout_s f64be, count u32be, count x
                (u32be len, review bytes) — BULK binary ingest: the
                whole batch feeds the MicroBatcher pre-parsed and the
                answer is an R frame of count x (u32be len, envelope
                bytes). The streaming path for CI scanners / service-
                mesh authorizers that skip HTTP framing entirely
                                                    (caller -> engine)

Shared-memory rings (tflags&2 / 'r' frames, control/shm.py): each
frontend owns a request ring + a reply ring; review bytes are written
ring-side at accept time and the frames carry (offset, length)
descriptors, so the socket — which remains the ordering and wakeup
channel — moves ~40 bytes per review instead of the payload. The
engine parses reviews out of the mapped ring (zero payload copies
across the backplane) and writes response envelopes into the reply
ring the same way. A burst that outruns the reader falls back to
inline-payload frames per request (alloc returns None past the
watermark); the accept loop never blocks on ring space.

N-engine plane (--admission-engines > 1): one engine PROCESS per chip,
each with its own Client/MicroBatcher/device and its own socket
(`<base>.<k>`); frontends hold one multiplexed connection per engine
and route each review to the least-loaded engine (fallback:
request-hash), failing over to the next engine when one dies
mid-burst. The PRIMARY process (engine 0, in-process) replicates every
library mutation to every engine child over L frames — each child's
Client bumps its own generation when the op lands, so decision-cache
keys stay coherent per engine — and polls per-engine metric totals
over M frames, merging deltas into its registry so shed accounting and
decision counts stay global.

Span context over the split: the FRONTEND makes the sampling decision
at the HTTP edge (it parses `traceparent`, answers `X-Trace-Id`); a
sampled request's Q frame carries the trace id plus the frontend's
receive/forward monotonic instants (CLOCK_MONOTONIC is system-wide, so
the engine compares them directly), and the engine reconstructs the
frontend_parse and backplane_forward spans, then times its own stages.
An UNSAMPLED request pays one zero byte on the wire and no span
allocations anywhere.

Resilience contract across the split:
  * deadlines propagate — the frame carries the request's timeout and
    the engine pins the absolute deadline AT FRAME RECEIPT, so executor
    queueing spends the request's budget, not a fresh one;
  * frontends answer per the fail-open/closed stance when the engine is
    unreachable or a verdict never lands (fault point
    `backplane.engine` arms that path for chaos runs);
  * shed accounting stays ENGINE-side (`--admission-max-queue` bounds
    the one shared batcher), so the bound is global, not per-worker;
  * SIGTERM drains frontends BEFORE the engine: the supervisor TERMs
    its children (each stops accepting, finishes in-flight HTTP
    requests), then the engine drains the shared batcher.
"""

from __future__ import annotations

import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

from ..utils import faults
from . import jsonio
from . import liveness
from . import shm
from . import trace as gtrace
from .logging import logger
from .webhook import (
    DEFAULT_WEBHOOK_TIMEOUT_S,
    MAX_WEBHOOK_TIMEOUT_S,
    encode_envelope,
    parse_timeout_query,
    request_deadline,
    route_path,
)

log = logger("backplane")

_Q_HEADER = struct.Struct("!Id")   # request id, timeout seconds
_Q_TRACE = struct.Struct("!16sdd")  # trace id, t_recv, t_fwd (monotonic)
_Q_PATHLEN = struct.Struct("!H")
_Q_RING = struct.Struct("!II")     # request-ring offset, payload length
_R_HEADER = struct.Struct("!IH")   # request id, http status
_R_RING = struct.Struct("!IHII")   # id, status, reply-ring offset, length
_B_HEADER = struct.Struct("!IdI")  # request id, timeout seconds, count
_B_LEN = struct.Struct("!I")
# tflags bits on Q frames
TF_TRACE = 0x1   # span context follows
TF_RING = 0x2    # body is a request-ring descriptor, not inline bytes

# frontends bucket forward latencies with the same bounds the engine
# registry renders — one constant, no drift into mislabeled buckets
from .metrics import FORWARD_BUCKETS as STATS_BUCKETS  # noqa: E402
from .metrics import STAGE_BUCKETS  # noqa: E402


def _bucket_observe(counts: list, bounds: tuple, seconds: float) -> None:
    """Accumulate one observation into a local histogram delta
    (counts carries len(bounds)+1 slots; the last is +Inf)."""
    for i, b in enumerate(bounds):
        if seconds <= b:
            counts[i] += 1
            return
    counts[-1] += 1

STATS_INTERVAL_S = 2.0
# R-frame status an engine answers while it is NOT READY to serve (a
# respawned engine child before its library sync): never surfaces as an
# HTTP verdict — the router fails the request over to a synced engine
STATUS_NOT_READY = 599
# per-operation socket timeout on backplane I/O: a WEDGED (not dead)
# peer must unblock senders so frontends can answer per the failure
# stance instead of hanging HTTP threads past their deadlines
IO_TIMEOUT_S = 2.0
# frame hygiene: upper bound on any length prefix accepted at parse
# time. A desynced/corrupted u32 (mid-stream reset, flipped bit) would
# otherwise commit the reader to recv'ing gigabytes of garbage and then
# smear every subsequent parse; an oversized header is treated as a
# torn stream — clean connection close, the client re-handshakes. Must
# comfortably exceed the largest legal frame (bulk B frames carry whole
# inventory slices; admission bodies are ~MBs at worst).
MAX_FRAME_LEN = 256 * 1024 * 1024


class FrameDesyncError(ConnectionError):
    """A length prefix failed the hygiene bound — the stream is torn
    (desynced or corrupted) and the only safe recovery is to drop the
    connection and re-handshake."""


def _check_frame_len(length: int) -> int:
    if length > MAX_FRAME_LEN:
        raise FrameDesyncError(
            f"backplane frame length {length} exceeds bound "
            f"{MAX_FRAME_LEN}; closing desynced connection")
    return length


class BackplaneError(Exception):
    """The engine could not be reached / the verdict never arrived —
    the frontend answers per the failure stance."""


# Q-frame body sentinels on the engine side: the review either arrived
# pre-parsed off the request ring, is still raw bytes, or was a ring
# payload that failed to parse (a torn slot after a cancel — answer 400)
_UNPARSED = object()
_BAD = object()


def default_socket_path() -> str:
    import tempfile

    return os.path.join(tempfile.gettempdir(),
                        f"gatekeeper-tpu-backplane-{os.getpid()}.sock")


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly n bytes. A socket TIMEOUT retries without losing
    the partial buffer (sockets carry a per-operation timeout so a
    wedged peer unblocks SENDERS; an idle reader just waits on)."""
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except TimeoutError:
            continue
        if not chunk:
            raise ConnectionError("backplane peer closed")
        buf += chunk
    return bytes(buf)


def _send_frame(sock: socket.socket, lock: threading.Lock,
                *parts) -> None:
    """Send one length-prefixed frame as a vectored write.

    The previous implementation concatenated `struct.pack("!I", n) +
    b"".join(parts)` — a full extra copy of every payload per frame, on
    top of the kernel's own. `sendmsg` hands the header and payload
    buffers to the kernel as an iovec instead; the rare partial send
    (payload larger than the socket buffer under backpressure) falls
    back to flattening just the unsent remainder."""
    plen = sum(len(p) for p in parts)
    header = struct.pack("!I", plen)
    wire_fault = faults.consume("backplane.wire")
    if wire_fault is not None:
        _fault_frame(sock, lock, header, parts, wire_fault)
        return
    bufs = (header, *parts)
    if len(bufs) > 1000:
        # sendmsg is capped at IOV_MAX (1024) iovecs — a bulk B frame
        # of >=500 reviews would hit EMSGSIZE and be misread as
        # connection loss; flatten once instead
        bufs = (header, b"".join(parts))
    with lock:
        try:
            sent = sock.sendmsg(bufs)
        except (AttributeError, NotImplementedError):
            # pragma: no cover - TLS/odd sockets (ssl raises
            # NotImplementedError, not AttributeError)
            sock.sendall(header + b"".join(parts))
            return
        if sent < 4 + plen:
            rest = b"".join(bufs)
            sock.sendall(memoryview(rest)[sent:])


def _fault_frame(sock: socket.socket, lock: threading.Lock,
                 header: bytes, parts: tuple, fault: tuple) -> None:
    """Act out an armed backplane.wire fault on this frame.

    reset    -> close the socket without sending a byte and raise as if
                the kernel reset the connection mid-frame
    truncate -> write the header + a partial payload, then close: the
                peer's length-prefixed read blocks on bytes that never
                come until its ConnectionError on the close
    slow     -> drip the frame out in small chunks with delays (frame
                eventually completes; exercises IO_TIMEOUT_S retries)
    """
    mode, param = fault
    frame = header + b"".join(parts)
    with lock:
        if mode == "reset":
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            sock.close()
            raise ConnectionResetError(
                "injected backplane.wire reset mid-frame")
        if mode == "truncate":
            cut = max(4, len(frame) // 2)
            try:
                sock.sendall(frame[:cut])
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            sock.close()
            raise ConnectionResetError(
                "injected backplane.wire truncated frame")
        # slow drip: param carries the per-chunk delay in seconds
        try:
            delay = float(param) if param else 0.05
        except ValueError:
            delay = 0.05
        chunk = 64
        for off in range(0, len(frame), chunk):
            sock.sendall(frame[off:off + chunk])
            # gklint: allow(block-zone) reason=the slow-drip fault EXISTS to stall this send; only reachable with backplane.wire armed by a chaos run
            time.sleep(delay)


# ----------------------------------------------------------------- engine


class BackplaneEngine:
    """The engine-side listener: owns the handlers (and through them the
    one shared MicroBatcher), decodes each forwarded review once, and
    answers with preserialized envelope bytes."""

    def __init__(self, socket_path: str, validation=None, ns_label=None,
                 mutation=None, max_workers: int = 128,
                 default_timeout: float = DEFAULT_WEBHOOK_TIMEOUT_S,
                 engine_id: str = "0", library_sink=None,
                 stats_source=None, preview=None, auditor=None):
        self.socket_path = socket_path
        self.validation = validation
        self.ns_label = ns_label
        self.mutation = mutation
        # what-if preview (control.preview.PreviewEngine): served on its
        # OWN single-thread executor, never the shared admission pool —
        # a multi-second inventory sweep must not occupy a thread an
        # admission verdict is waiting for
        self.preview = preview
        self._preview_pool = None
        # audit shard server (control.audit.AuditSliceServer): same
        # isolation contract as preview — a slice sweep is a multi-
        # second evaluation and rides its own single-thread executor
        self.auditor = auditor
        self._audit_pool = None
        self.default_timeout = default_timeout
        self.engine_id = str(engine_id)
        # L-frame handler (engine children): applies one replicated
        # library op to this engine's Client/MutationSystem
        self.library_sink = library_sink
        # M-frame handler: answers the primary's stats poll (defaults
        # to the registry's relay snapshot in engine children)
        self.stats_source = stats_source
        # when set, Q frames answer STATUS_NOT_READY until it returns
        # True: a RESPAWNED engine child must not serve admission
        # verdicts from its empty pre-sync library — the router fails
        # those requests over to a synced engine
        self.ready_check: Optional[Callable[[], bool]] = None
        self._max_workers = max_workers
        self._listener: Optional[socket.socket] = None
        self._pool = None
        self._accept_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._conns: dict[int, tuple] = {}  # fd -> (sock, wlock, worker)
        self._conns_lock = threading.Lock()
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self.configured_workers = 0  # set by the Runtime for the gauge

    # lifecycle ------------------------------------------------------

    def start(self) -> None:
        from concurrent.futures import ThreadPoolExecutor

        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        self._pool = ThreadPoolExecutor(
            max_workers=self._max_workers,
            thread_name_prefix="backplane-serve")
        if self.preview is not None:
            self._preview_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="preview-serve")
        if self.auditor is not None:
            self._audit_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="auditslice-serve")
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self.socket_path)
        self._listener.listen(64)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="backplane-accept", daemon=True)
        self._accept_thread.start()

        def _probe():
            from . import metrics
            with self._inflight_lock:
                n = self._inflight
            metrics.report_queue_depth("backplane_engine", n,
                                       engine=self.engine_id)

        from . import metrics as _metrics
        _metrics.register_saturation_probe(
            f"backplane-engine-{self.engine_id}", _probe)
        log.info("backplane engine listening",
                 details={"socket": self.socket_path})

    def alive(self) -> bool:
        t = self._accept_thread
        return bool(t and t.is_alive()) and not self._stop.is_set()

    @property
    def connected(self) -> int:
        with self._conns_lock:
            return len(self._conns)

    def abort(self) -> None:
        """Drop dead NOW — no drain, no batcher teardown. The chaos
        suite uses this to emulate an engine crash (kill -9) under a
        live burst: every frontend's in-flight forward fails over to
        the failure-stance answer."""
        from . import metrics
        metrics.unregister_saturation_probe(
            f"backplane-engine-{self.engine_id}")
        metrics.report_queue_depth("backplane_engine", 0,
                                   engine=self.engine_id)
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._conns_lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for sock, _wlock, _worker in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass

    def stop(self, drain_timeout: float = 10.0) -> None:
        """Called AFTER the frontends drained: no new frames arrive, so
        finish the in-flight verdicts, drain the shared batcher, and
        tear the listener down."""
        from . import metrics
        metrics.unregister_saturation_probe(
            f"backplane-engine-{self.engine_id}")
        metrics.report_queue_depth("backplane_engine", 0,
                                   engine=self.engine_id)
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        end = time.monotonic() + drain_timeout
        while time.monotonic() < end:
            with self._inflight_lock:
                if self._inflight == 0:
                    break
            time.sleep(0.02)
        for handler in (self.validation, self.mutation):
            if handler is not None:
                handler.batcher.drain(max(0.5, end - time.monotonic()))
                handler.batcher.stop()
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
        if self._preview_pool is not None:
            self._preview_pool.shutdown(wait=False, cancel_futures=True)
        if self._audit_pool is not None:
            self._audit_pool.shutdown(wait=False, cancel_futures=True)
        with self._conns_lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for sock, _wlock, _worker in conns:
            try:
                sock.close()
            except OSError:
                pass
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass

    # accept / read --------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            # generous per-op timeout: a stuck FRONTEND must not pin an
            # engine worker thread in sendall forever (the supervisor
            # respawns it and the dead conn errors out)
            conn.settimeout(30.0)
            wlock = threading.Lock()
            with self._conns_lock:
                self._conns[conn.fileno()] = (conn, wlock, None)
            threading.Thread(target=self._read_loop, args=(conn, wlock),
                             name="backplane-read", daemon=True).start()

    def _read_loop(self, conn: socket.socket, wlock: threading.Lock) -> None:
        fd = conn.fileno()
        rings = None  # this frontend's shm ring pair, attached on hello
        try:
            while not self._stop.is_set():
                (length,) = struct.unpack("!I", _recv_exact(conn, 4))
                payload = _recv_exact(conn, _check_frame_len(length))
                kind = payload[:1]
                if kind == b"Q":
                    rid, timeout_s = _Q_HEADER.unpack_from(payload, 1)
                    if self.ready_check is not None \
                            and not self.ready_check():
                        _send_frame(conn, wlock, b"R",
                                    _R_HEADER.pack(rid,
                                                   STATUS_NOT_READY),
                                    b"engine awaiting library sync")
                        continue
                    off = 1 + _Q_HEADER.size
                    tflags = payload[off]
                    off += 1
                    tr = gtrace.NOOP
                    if tflags & TF_TRACE:
                        # sampled: reconstruct the frontend-side spans
                        # from the carried span context (same-host
                        # CLOCK_MONOTONIC). frontend_parse is remote —
                        # the frontend ships its histogram delta over S
                        # frames, so the engine's metrics sink must not
                        # double it. backplane_forward (t_fwd -> frame
                        # receipt) is timed HERE and histogrammed here:
                        # it is the true one-way hop — the frontend
                        # only knows its full call round trip, which
                        # would re-count every engine stage
                        tid, t_recv, t_fwd = _Q_TRACE.unpack_from(
                            payload, off)
                        off += _Q_TRACE.size
                        tr = gtrace.TRACER.resume(gtrace.ADMISSION,
                                                  tid.hex())
                        tr.t0 = t_recv  # the trace starts at the edge
                        tr.add_span("frontend_parse", t_recv, t_fwd,
                                    remote=True)
                        tr.add_span("backplane_forward", t_fwd,
                                    time.monotonic())
                    (plen,) = _Q_PATHLEN.unpack_from(payload, off)
                    off += _Q_PATHLEN.size
                    path = payload[off:off + plen].decode("ascii", "replace")
                    off += plen
                    review = _UNPARSED
                    body = b""
                    if tflags & TF_RING and rings is not None:
                        # descriptor frame: the review lives in this
                        # frontend's request ring. Parse it HERE, zero-
                        # copy off the mapped segment, so the slot
                        # releases in FIFO order with the descriptors —
                        # the engine's only per-review byte work is the
                        # JSON decode it had to do anyway.
                        roff, rlen = _Q_RING.unpack_from(payload, off)
                        t_ring0 = time.monotonic() if tr.sampled else 0.0
                        try:
                            review = jsonio.loads(
                                rings.req.view(roff, rlen))
                        except ValueError:
                            review = _BAD
                        finally:
                            rings.req.release(roff)
                        if tr.sampled:
                            tr.add_span("ring_read", t_ring0,
                                        time.monotonic())
                        if review is not _BAD \
                                and route_path(path) in ("preview",
                                                         "auditslice"):
                            # previews/audit sweeps consume raw body
                            # bytes (the client avoids the ring for
                            # them; this is the defensive path)
                            body = jsonio.dumps_bytes(review)
                            review = _UNPARSED
                    else:
                        body = payload[off:]
                    # deadline pinned HERE: queueing ahead of the serve
                    # call spends the request's own budget
                    deadline = request_deadline(
                        {"timeoutSeconds": timeout_s} if timeout_s > 0
                        else {}, self.default_timeout)
                    # fast path: decision-cache hits, short-circuits,
                    # and the namespace-label check are answered INLINE
                    # — no thread handoff on the hot path. Only
                    # requests that must evaluate take the pool (which
                    # reuses the already-parsed review).
                    try:
                        inline = self._try_inline(timeout_s, deadline,
                                                  path, body, tr,
                                                  review=review)
                    except Exception as e:
                        log.error("backplane inline serve error",
                                  details=str(e))
                        inline = (500, b"")
                    if inline[0] not in ("eval", "eval-preview",
                                         "eval-audit"):
                        # a failed/partial send desyncs the stream:
                        # close and let the frontend reconnect
                        t_send = time.monotonic()
                        self._respond_frame(conn, wlock, rings, rid,
                                            inline[0], inline[1])
                        if tr.sampled:
                            tr.add_span("respond", t_send,
                                        time.monotonic())
                            tr.finish()
                        continue
                    with self._inflight_lock:
                        self._inflight += 1
                    # preview/audit sweeps ride their own single-thread
                    # executors: admission verdicts never queue behind
                    # a multi-second inventory evaluation
                    pool = (self._preview_pool
                            if inline[0] == "eval-preview"
                            else self._audit_pool
                            if inline[0] == "eval-audit"
                            else self._pool)
                    pool.submit(self._serve, conn, wlock, rid,
                                timeout_s, deadline, path, body,
                                inline[1], tr, time.monotonic(), rings)
                elif kind == b"B":
                    # BULK binary ingest: one frame, many pre-framed
                    # reviews, fed to the MicroBatcher as one submit —
                    # the streaming path for callers that skip HTTP
                    rid, timeout_b, count = _B_HEADER.unpack_from(
                        payload, 1)
                    if self.ready_check is not None \
                            and not self.ready_check():
                        _send_frame(conn, wlock, b"R",
                                    _R_HEADER.pack(rid,
                                                   STATUS_NOT_READY),
                                    b"engine awaiting library sync")
                        continue
                    deadline = request_deadline(
                        {"timeoutSeconds": timeout_b} if timeout_b > 0
                        else {}, self.default_timeout)
                    with self._inflight_lock:
                        self._inflight += 1
                    self._pool.submit(self._serve_bulk, conn, wlock,
                                      rid, deadline, payload, count)
                elif kind == b"H":
                    info = jsonio.loads(payload[1:]) or {}
                    worker = str(info.get("worker", "?"))
                    with self._conns_lock:
                        if fd in self._conns:
                            self._conns[fd] = (conn, wlock, worker)
                    self._report_workers()
                    ring_names = info.get("rings")
                    if ring_names:
                        ack = False
                        try:
                            rings = shm.EngineRings(ring_names)
                            ack = True
                        except Exception as e:
                            rings = None
                            log.warning(
                                "ring attach failed; inline payloads",
                                details=str(e))
                        _send_frame(conn, wlock, b"A",
                                    jsonio.dumps_bytes({"rings": ack}))
                    log.info("frontend connected",
                             details={"worker": worker,
                                      "rings": rings is not None})
                elif kind == b"S":
                    self._merge_stats(jsonio.loads(payload[1:]) or {})
                elif kind == b"L":
                    # replicated library op from the primary: applied
                    # INLINE on this read loop, so ops from the one
                    # control connection apply in send order (the
                    # engine's own Client bumps its generation under
                    # the op — decision-cache coherence needs no extra
                    # fence). Admission traffic rides the frontends'
                    # separate connections, unaffected.
                    (rid,) = struct.unpack("!I", payload[1:5])
                    status, out = 200, b""
                    try:
                        if self.library_sink is None:
                            status = 404
                        else:
                            self.library_sink(jsonio.loads(payload[5:])
                                              or {})
                    except Exception as e:
                        log.error("library replication op failed",
                                  details=str(e))
                        status = 500
                        out = str(e).encode("utf-8", "replace")[:512]
                    _send_frame(conn, wlock, b"R",
                                _R_HEADER.pack(rid, status), out)
                elif kind == b"M":
                    (rid,) = struct.unpack("!I", payload[1:5])
                    try:
                        src = self.stats_source
                        stats = src() if src is not None else {}
                        _send_frame(conn, wlock, b"R",
                                    _R_HEADER.pack(rid, 200),
                                    jsonio.dumps_bytes(stats))
                    except Exception as e:
                        log.error("stats poll failed", details=str(e))
                        _send_frame(conn, wlock, b"R",
                                    _R_HEADER.pack(rid, 500), b"")
        except FrameDesyncError as e:
            log.error("backplane frame desync; dropping connection",
                      details=str(e))
        except (ConnectionError, OSError):
            pass
        finally:
            with self._conns_lock:
                ent = self._conns.pop(fd, None)
            worker = ent[2] if ent else None
            if worker is not None:
                # gauges only ever SET: a frontend that died mid-burst
                # would otherwise export its last (high) in-flight
                # forever — zero it, since a dead frontend truthfully
                # has nothing in flight
                try:
                    from . import metrics
                    metrics.report_backplane_inflight(worker, 0)
                    if rings is not None:
                        metrics.report_ring_fill(worker, 0.0)
                except Exception:
                    pass
            if rings is not None:
                # engine-side DETACH on connection loss: the frontend
                # (or its supervisor) owns unlinking; any in-flight
                # descriptors already failed with their waiters
                rings.close()
            try:
                conn.close()
            except OSError:
                pass
            if not self._stop.is_set():
                self._report_workers()

    def _report_workers(self) -> None:
        from . import metrics

        metrics.report_admission_workers(self.configured_workers,
                                         self.connected)

    def _merge_stats(self, stats: dict) -> None:
        from . import metrics

        worker = str(stats.get("worker", "?"))
        counts = stats.get("buckets") or []
        n = int(stats.get("count") or 0)
        if n:
            metrics.report_backplane_forward(
                worker, counts, float(stats.get("sum") or 0.0), n)
        errs = int(stats.get("errors") or 0)
        if errs:
            metrics.report_backplane_error(worker, errs)
        if "inflight" in stats:
            # sampled per stats interval: how many forwarded reviews
            # this frontend is still waiting on — the saturation read
            # that separates "frontends backed up" from "engine idle"
            metrics.report_backplane_inflight(
                worker, int(stats.get("inflight") or 0))
        # ring-path accounting: how many of this frontend's forwards
        # rode the shm ring vs fell back to inline payloads (burst
        # outran the reader / oversized review), plus the request
        # ring's sampled fill fraction — the "is the ring sized right"
        # read off one scrape
        for pth, n in (stats.get("ring_paths") or {}).items():
            if n:
                metrics.report_backplane_ring(worker, str(pth), int(n))
        if "ring_fill" in stats:
            metrics.report_ring_fill(
                worker, float(stats.get("ring_fill") or 0.0))
        # frontend-side span deltas (sampled requests only): each
        # frontend ships aggregated histograms for the stages it owns
        # (frontend_parse) — the engine's trace sink skips those
        # remote spans so they are counted exactly once
        from .stages import STAGE_NAMES
        for stage, d in (stats.get("stages") or {}).items():
            n = int(d.get("count") or 0)
            if n and str(stage) in STAGE_NAMES:
                # wire-supplied names bounded against the central
                # stage registry: a version-skewed frontend cannot
                # mint label series the dashboards don't know
                # gklint: allow(stage) reason=runtime-folded against control/stages.py STAGE_NAMES on the line above
                metrics.report_stage_bucketed(
                    "admission", str(stage), d.get("buckets") or [],
                    float(d.get("sum") or 0.0), n)

    # serve ----------------------------------------------------------

    @staticmethod
    def _fold_timeout(review, timeout_s: float, deadline: float):
        """Merge the frame's ?timeout= budget into the request and pick
        the effective deadline: a body-carried timeoutSeconds (tests /
        direct callers) WINS over the frame's query budget — matching
        the single-process server — in which case the handler derives
        the deadline from the body (deadline=None)."""
        request = (review or {}).get("request") \
            if isinstance(review, dict) else None
        if not isinstance(request, dict):
            return deadline
        if "timeoutSeconds" in request:
            return None
        if timeout_s > 0:
            request["timeoutSeconds"] = timeout_s
        return deadline

    def _try_inline(self, timeout_s: float, deadline: float, path: str,
                    body: bytes, tr=gtrace.NOOP, review=_UNPARSED) -> tuple:
        """(status, payload) when the verdict needs no blocking work
        (cache hit / short-circuit / namespace-label check / 404);
        ("eval", parsed_review_or_None) hands it to the worker pool.
        `review` carries the pre-parsed review when the body arrived as
        a ring descriptor (the read loop decodes it zero-copy)."""
        route = route_path(path)
        if review is _BAD:
            # a ring slot that failed to parse: torn by a cancel (the
            # waiter is already gone) or a corrupt writer — 400, never
            # a handler call on garbage
            return (400, b"")
        if route == "admitlabel":
            if self.ns_label is None:
                return (404, b"")
            if review is _UNPARSED:
                try:
                    review = jsonio.loads(body)
                except ValueError:
                    return (400, b"")
            return (200, encode_envelope(self.ns_label.handle(review)))
        if route == "admit":
            if self.validation is None:
                return (404, b"")
            if review is _UNPARSED:
                try:
                    review = jsonio.loads(body)
                except ValueError:
                    return (400, b"")
            eff_deadline = self._fold_timeout(review, timeout_s, deadline)
            out = self.validation.handle(review, deadline=eff_deadline,
                                         fast=True, trace=tr)
            if out is None:
                # cache miss: evaluation needs a thread; hand over the
                # parsed review AND the folded deadline
                return ("eval", (review, eff_deadline))
            if not tr.sampled:
                return (200, encode_envelope(out))
            with tr.span("serialize"):
                payload = encode_envelope(out)
            return (200, payload)
        if route == "mutate":
            if self.mutation is None:
                return (404, b"")
            if review is _UNPARSED:
                # inline payload: parse on the pool thread, off the
                # read loop (mutation payloads can be large)
                return ("eval", None)
            return ("eval",
                    (review, self._fold_timeout(review, timeout_s,
                                                deadline)))
        if route == "preview":
            return ("eval-preview", None) if self.preview is not None \
                else (404, b"")
        if route == "auditslice":
            return ("eval-audit", None) if self.auditor is not None \
                else (404, b"")
        return (404, b"")

    def _respond_frame(self, conn, wlock, rings, rid: int, status: int,
                       out: bytes) -> None:
        """Answer one Q frame: descriptor over the reply ring when the
        frontend has one and the payload fits (zero payload copies on
        the socket), else the inline R frame. Raises OSError upward —
        the caller owns desync handling."""
        if rings is not None and out:
            try:
                roff = rings.reply.append(out)
            except (TypeError, ValueError):  # ring torn down mid-serve
                roff = None
            if roff is not None:
                try:
                    _send_frame(conn, wlock, b"r",
                                _R_RING.pack(rid, status, roff,
                                             len(out)))
                except OSError:
                    try:
                        rings.reply.cancel(roff)
                    except (TypeError, ValueError):
                        pass
                    raise
                return
        _send_frame(conn, wlock, b"R", _R_HEADER.pack(rid, status), out)

    def _serve(self, conn: socket.socket, wlock: threading.Lock,
               rid: int, timeout_s: float, deadline: float, path: str,
               body: bytes, handoff=None, tr=gtrace.NOOP,
               t_queued: float = 0.0, rings=None) -> None:
        review = None
        if handoff is not None:
            review, deadline = handoff
        if tr.sampled:
            # executor queue wait: frame receipt -> a pool thread
            # actually picked the request up
            tr.add_span("engine_queue", t_queued, time.monotonic())
        try:
            status, out = self._decide(timeout_s, deadline, path, body,
                                       review=review, tr=tr)
            t_send = time.monotonic()
            try:
                self._respond_frame(conn, wlock, rings, rid, status,
                                    out)
            except OSError:
                # frontend died or the send timed out mid-frame — the
                # stream may be desynced, so close it (the supervisor
                # respawns the worker, which reconnects clean)
                try:
                    conn.close()
                except OSError:
                    pass
            if tr.sampled:
                tr.add_span("respond", t_send, time.monotonic())
                tr.finish()
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def _serve_bulk(self, conn: socket.socket, wlock: threading.Lock,
                    rid: int, deadline: float, payload: bytes,
                    count: int) -> None:
        """One B frame: parse every length-prefixed review, feed the
        whole batch to the MicroBatcher via handle_bulk (one enqueue
        pass, shared seals), answer count x (len, envelope) in one R
        frame."""

        def send(*parts):
            # any partial/failed send desyncs the multiplexed stream:
            # close so the caller reconnects clean (same contract as
            # _serve)
            try:
                _send_frame(conn, wlock, *parts)
            except OSError:
                try:
                    conn.close()
                except OSError:
                    pass

        try:
            reviews = []
            off = 1 + _B_HEADER.size
            try:
                for _ in range(count):
                    (n,) = _B_LEN.unpack_from(payload, off)
                    off += _B_LEN.size
                    reviews.append(
                        jsonio.loads(memoryview(payload)[off:off + n]))
                    off += n
            except (ValueError, struct.error):
                send(b"R", _R_HEADER.pack(rid, 400), b"")
                return
            if self.validation is None:
                send(b"R", _R_HEADER.pack(rid, 404), b"")
                return
            try:
                outs = self.validation.handle_bulk(reviews, deadline)
            except Exception as e:
                log.error("bulk ingest failed", details=str(e))
                send(b"R", _R_HEADER.pack(rid, 500),
                     str(e).encode("utf-8", "replace")[:512])
                return
            parts = [_R_HEADER.pack(rid, 200), _B_LEN.pack(len(outs))]
            for env in outs:
                item = encode_envelope(env)
                parts.append(_B_LEN.pack(len(item)))
                parts.append(item)
            send(b"R", *parts)
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def _decide(self, timeout_s: float, deadline: float, path: str,
                body: bytes, review=None,
                tr=gtrace.NOOP) -> tuple[int, bytes]:
        if review is None:
            try:
                review = jsonio.loads(body)
            except ValueError:
                return 400, b""
            deadline = self._fold_timeout(review, timeout_s, deadline)
        # (a review handed over by _try_inline already has the timeout
        # folded and the deadline pinned at frame receipt)
        route = route_path(path)
        try:
            if route == "preview" and self.preview is not None:
                return self.preview.handle_http(body)
            if route == "auditslice" and self.auditor is not None:
                return self.auditor.handle_http(body)
            if route == "admitlabel" and self.ns_label is not None:
                out = self.ns_label.handle(review)
            elif route == "admit" and self.validation is not None:
                out = self.validation.handle(review, deadline=deadline,
                                             trace=tr)
            elif route == "mutate" and self.mutation is not None:
                out = self.mutation.handle(review, deadline=deadline,
                                           trace=tr)
            else:
                return 404, b""
            if not tr.sampled:
                return 200, encode_envelope(out)
            with tr.span("serialize"):
                payload = encode_envelope(out)
            return 200, payload
        except Exception as e:  # handlers answer their own errors; this
            # is the backstop for anything outside them
            log.error("backplane serve error", details=str(e))
            return 500, b""


# ----------------------------------------------------------------- client


class _Waiter:
    __slots__ = ("event", "status", "body")

    def __init__(self):
        self.event = threading.Event()
        self.status = 0
        self.body = b""


class BackplaneClient:
    """Frontend-side connection to the engine: one multiplexed UDS
    socket, a reader thread resolving verdicts by request id. Thread-
    safe; every HTTP handler thread calls `call()` concurrently.

    With `ring_mb` > 0 the client owns a shared-memory ring pair
    (control/shm.py): review bytes are written into the request ring
    and Q frames carry descriptors; responses come back as reply-ring
    descriptors resolved to zero-copy RingSlice payloads. The ring is
    an optimization with an always-available inline fallback — ring
    creation failure, a missing engine ack, an oversized review, or an
    exhausted ring all degrade to the original inline frames."""

    def __init__(self, socket_path: str, worker_id: str = "0",
                 connect_timeout: float = 1.0, ring_mb: float = 0.0,
                 ring_prefix: str = ""):
        self.socket_path = socket_path
        self.worker_id = worker_id
        self.connect_timeout = connect_timeout
        self._sock: Optional[socket.socket] = None
        self._wlock = threading.Lock()
        # reentrant: _ensure_connected calls _drop() from inside its
        # own critical section when the engine dies between connect()
        # and the hello send (the chaos suite's SIGKILL window) — a
        # plain Lock self-deadlocks there, wedging every HTTP thread
        # of the frontend behind a lock nobody will ever release
        self._conn_lock = threading.RLock()
        self._pending: dict[int, _Waiter] = {}
        self._pending_lock = threading.Lock()
        self._next_id = 0
        self._closed = False
        # optional hooks the FrontendServer installs: per-forward ring
        # path counts ("ring"/"inline") and sampled ring_write stage
        # durations, both shipped engine-side over S frames
        self.stats_hook = None
        self.stage_hook = None
        self._rings = None
        self._ring_ok = threading.Event()
        if ring_mb > 0 and shm.supported():
            prefix = ring_prefix \
                or f"gk-bp-{os.getpid()}-{worker_id}"
            try:
                self._rings = shm.ClientRings(
                    prefix, max(1, int(ring_mb * 1024 * 1024)))
            except OSError as e:
                log.warning("shm ring unavailable; inline payloads",
                            details=str(e))

    # connection -----------------------------------------------------

    def _ensure_connected(self) -> socket.socket:
        sock = self._sock
        if sock is not None:
            return sock
        with self._conn_lock:
            if self._sock is not None:
                return self._sock
            if self._closed:
                raise BackplaneError("backplane client closed")
            try:
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                sock.settimeout(self.connect_timeout)
                sock.connect(self.socket_path)
                # per-op timeout: a wedged engine must unblock sendall
                # (the reader retries timeouts inside _recv_exact, so
                # an idle connection never desyncs)
                sock.settimeout(IO_TIMEOUT_S)
            except OSError as e:
                raise BackplaneError(
                    f"admission engine unreachable: {e}") from e
            self._sock = sock
            threading.Thread(target=self._read_loop, args=(sock,),
                             name="backplane-client-read",
                             daemon=True).start()
            hello = {"worker": self.worker_id}
            if self._rings is not None:
                # descriptors flow only after the engine's A-frame ack
                # confirms it attached this pair
                self._ring_ok.clear()
                hello["rings"] = self._rings.hello()
            try:
                _send_frame(sock, self._wlock, b"H",
                            jsonio.dumps_bytes(hello))
            except OSError as e:
                self._drop(sock)
                raise BackplaneError(
                    f"admission engine unreachable: {e}") from e
            return sock

    def _drop(self, sock: socket.socket) -> None:
        with self._conn_lock:
            current = self._sock is sock
            if current:
                self._sock = None
        try:
            sock.close()
        except OSError:
            pass
        if not current:
            # stale drop: the old reader thread unwinding AFTER the
            # sender already dropped (or replaced) this connection.
            # Its waiters were failed by the first drop — touching
            # the pending table again would kill requests riding the
            # replacement connection.
            return
        self._ring_ok.clear()
        # every in-flight request on the dead connection fails NOW —
        # the frontends answer per the failure stance instead of
        # letting HTTP callers hang into their own timeouts
        with self._pending_lock:
            waiters = list(self._pending.values())
            self._pending.clear()
        for w in waiters:
            w.status = -1
            w.event.set()
        if self._rings is not None:
            # the engine detached: free every outstanding request-ring
            # slot (their waiters just failed) so the ring cannot silt
            self._rings.on_disconnect()

    def _read_loop(self, sock: socket.socket) -> None:
        try:
            while True:
                (length,) = struct.unpack("!I", _recv_exact(sock, 4))
                payload = _recv_exact(sock, _check_frame_len(length))
                kind = payload[:1]
                if kind == b"R":
                    rid, status = _R_HEADER.unpack_from(payload, 1)
                    with self._pending_lock:
                        waiter = self._pending.pop(rid, None)
                    if waiter is not None:
                        waiter.status = status
                        waiter.body = payload[1 + _R_HEADER.size:]
                        waiter.event.set()
                elif kind == b"r":
                    # reply-ring descriptor: the payload never crossed
                    # the socket — hand the waiter a zero-copy slice it
                    # releases after the final HTTP send
                    rid, status, roff, rlen = _R_RING.unpack_from(
                        payload, 1)
                    rings = self._rings  # close() may null it mid-loop
                    with self._pending_lock:
                        waiter = self._pending.pop(rid, None)
                    if waiter is None:
                        # abandoned waiter (deadline fired): release
                        # the slot NOW or the reply ring silts up
                        if rings is not None:
                            rings.reply.release(roff)
                        continue
                    waiter.status = status
                    waiter.body = rings.reply_slice(roff, rlen) \
                        if rings is not None else b""
                    waiter.event.set()
                elif kind == b"A":
                    ack = jsonio.loads(payload[1:]) or {}
                    if ack.get("rings") and self._rings is not None:
                        self._ring_ok.set()
        except FrameDesyncError as e:
            log.error("backplane frame desync; dropping connection",
                      details=str(e))
        except (ConnectionError, OSError, struct.error):
            pass
        finally:
            self._drop(sock)

    def connected(self) -> bool:
        return self._sock is not None

    def ensure_connected(self) -> None:
        """Eager connect (boot-time): lets the engine's connected-
        workers gauge reflect the plane before the first request."""
        self._ensure_connected()

    def inflight(self) -> int:
        """Requests forwarded and not yet answered — the router's
        least-load signal."""
        with self._pending_lock:
            return len(self._pending)

    def close(self) -> None:
        self._closed = True
        sock = self._sock
        if sock is not None:
            self._drop(sock)
        if self._rings is not None:
            rings, self._rings = self._rings, None
            rings.close(unlink_segments=True)

    def ring_fill(self) -> Optional[float]:
        """Request-ring used fraction (None when no ring) — shipped in
        the S-frame stats as the ring-sizing saturation read."""
        if self._rings is None:
            return None
        try:
            return self._rings.req.used_fraction()
        except (TypeError, ValueError):
            return None

    # calls ----------------------------------------------------------

    def call(self, path: str, body: bytes, timeout_s: float,
             deadline: float,
             trace_ctx: Optional[tuple] = None) -> tuple[int, bytes]:
        """Forward one review; returns (http_status, response_bytes).
        Raises BackplaneError when the engine is unreachable, the
        connection dies mid-flight, or no verdict lands by `deadline`
        (+ grace) — the caller answers per the failure stance.

        `trace_ctx` = (trace_id_hex, t_recv_monotonic) for a SAMPLED
        request: the span context rides the Q frame (t_fwd is stamped
        here, just before the send) so the engine reconstructs the
        frontend-side spans."""
        try:
            faults.fire("backplane.engine")
        except BackplaneError:
            raise
        except Exception as e:
            # an armed raise/error fault means "engine unreachable":
            # surface it as the typed error so the HTTP handler answers
            # per the failure stance instead of dropping the socket
            raise BackplaneError(f"injected engine fault: {e}") from e
        sock = self._ensure_connected()
        # ring write FIRST (before the waiter registers): the review
        # bytes land in the shared segment and only a ~40-byte
        # descriptor rides the socket. None (ring full / oversized /
        # unacked) falls back to the inline frame for THIS request.
        # Local ref: a concurrent close() nulls self._rings mid-call.
        rings = self._rings
        roff = None
        if rings is not None and self._ring_ok.is_set() \
                and not path.startswith(("/v1/preview",
                                         "/v1/auditslice")):
            t_w0 = time.monotonic()
            try:
                roff = rings.req.append(body)
            except (TypeError, ValueError):  # torn down concurrently
                roff = None
            if roff is not None and trace_ctx is not None \
                    and self.stage_hook is not None:
                self.stage_hook("ring_write", time.monotonic() - t_w0)
        if rings is not None and self.stats_hook is not None:
            self.stats_hook("ring" if roff is not None else "inline")
        # trace block built BEFORE the waiter registers: nothing
        # between registration and the send may raise anything but the
        # handled OSError, or the pending entry leaks forever
        flags = (TF_RING if roff is not None else 0) \
            | (TF_TRACE if trace_ctx is not None else 0)
        if trace_ctx is None:
            tblock = bytes((flags,))
        else:
            tid_hex, t_recv = trace_ctx
            tblock = bytes((flags,)) + _Q_TRACE.pack(
                bytes.fromhex(tid_hex)[:16].ljust(16, b"\x00"),
                t_recv, time.monotonic())
        tail = _Q_RING.pack(roff, len(body)) if roff is not None \
            else body
        waiter = _Waiter()
        with self._pending_lock:
            self._next_id = (self._next_id + 1) & 0xFFFFFFFF
            rid = self._next_id
            self._pending[rid] = waiter
        try:
            _send_frame(sock, self._wlock, b"Q",
                        _Q_HEADER.pack(rid, timeout_s or 0.0), tblock,
                        _Q_PATHLEN.pack(len(path)), path.encode("ascii"),
                        tail)
        except OSError as e:
            with self._pending_lock:
                self._pending.pop(rid, None)
            if roff is not None:
                try:
                    rings.req.cancel(roff)
                except (TypeError, ValueError):
                    pass  # ring torn down concurrently
            self._drop(sock)
            raise BackplaneError(
                f"admission engine connection lost: {e}") from e
        # the engine's own deadline logic answers BEFORE the deadline;
        # the grace covers frame transit — expiry here means the engine
        # is gone or wedged
        if not waiter.event.wait(max(0.0, deadline - time.monotonic())
                                 + 0.5):
            with self._pending_lock:
                self._pending.pop(rid, None)
            if roff is not None:
                # nobody will consume the slot; free it (a wedged-but-
                # alive engine may later parse the reused bytes and
                # 400 a request id nobody waits on — harmless)
                try:
                    rings.req.cancel(roff)
                except (TypeError, ValueError):
                    pass  # ring torn down concurrently
            raise BackplaneError("admission engine verdict timed out")
        if waiter.status < 0:
            raise BackplaneError("admission engine connection lost")
        return waiter.status, waiter.body

    def send_stats(self, stats: dict) -> None:
        sock = self._sock
        if sock is None:
            return
        try:
            _send_frame(sock, self._wlock, b"S", jsonio.dumps_bytes(stats))
        except OSError:
            self._drop(sock)

    def _request_frame(self, kind: bytes, body: bytes,
                       timeout: float) -> tuple[int, bytes]:
        """One control round trip (L/M frames): send, wait on the
        shared waiter map. Raises BackplaneError on loss/timeout."""
        sock = self._ensure_connected()
        waiter = _Waiter()
        with self._pending_lock:
            self._next_id = (self._next_id + 1) & 0xFFFFFFFF
            rid = self._next_id
            self._pending[rid] = waiter
        try:
            _send_frame(sock, self._wlock, kind, struct.pack("!I", rid),
                        body)
        except OSError as e:
            with self._pending_lock:
                self._pending.pop(rid, None)
            self._drop(sock)
            raise BackplaneError(
                f"engine connection lost: {e}") from e
        if not waiter.event.wait(timeout):
            with self._pending_lock:
                self._pending.pop(rid, None)
            raise BackplaneError("engine control call timed out")
        if waiter.status < 0:
            raise BackplaneError("engine connection lost")
        return waiter.status, waiter.body

    def control(self, op: dict, timeout: float = 30.0) -> None:
        """Replicate one library op to this engine (primary-side).
        Raises BackplaneError when the op did not land — the caller
        marks the engine dirty and resyncs."""
        status, body = self._request_frame(
            b"L", jsonio.dumps_bytes(op), timeout)
        if status != 200:
            raise BackplaneError(
                f"library op refused ({status}): "
                f"{body.decode('utf-8', 'replace')[:200]}")

    def poll_stats(self, timeout: float = 10.0) -> dict:
        """Fetch this engine's relayed-metrics snapshot (M frame)."""
        status, body = self._request_frame(b"M", b"", timeout)
        if status != 200:
            raise BackplaneError(f"stats poll refused ({status})")
        try:
            return jsonio.loads(body) or {}
        except ValueError as e:
            raise BackplaneError(f"stats poll unparseable: {e}") from e

    def review_bulk(self, payloads: list, timeout_s: float = 30.0
                    ) -> list[bytes]:
        """STREAMING binary ingest: ship a whole batch of serialized
        AdmissionReviews as one length-prefixed B frame (no HTTP/1.1
        framing, no per-review frames) and get the envelope bytes back
        in order. The engine parses once and feeds the MicroBatcher in
        one enqueue pass — the bulk-caller path for CI scanners and
        service-mesh authorizers. Raises BackplaneError on loss or
        timeout."""
        return self.review_bulk_finish(
            self.review_bulk_begin(payloads, timeout_s))

    def review_bulk_begin(self, payloads: list,
                          timeout_s: float = 30.0) -> tuple:
        """Send one B frame and return immediately with a ticket for
        `review_bulk_finish` — the pipelining half of `review_bulk`.
        Bulk callers (the fleet scanner) keep K frames in flight so
        the next batch encodes host-side while this one evaluates in
        the engine; the frame-id/waiter plumbing already multiplexes
        replies, so depth costs no thread per in-flight frame."""
        sock = self._ensure_connected()
        waiter = _Waiter()
        with self._pending_lock:
            self._next_id = (self._next_id + 1) & 0xFFFFFFFF
            rid = self._next_id
            self._pending[rid] = waiter
        parts = [_B_HEADER.pack(rid, timeout_s or 0.0, len(payloads))]
        for b in payloads:
            parts.append(_B_LEN.pack(len(b)))
            parts.append(b)
        try:
            _send_frame(sock, self._wlock, b"B", *parts)
        except OSError as e:
            with self._pending_lock:
                self._pending.pop(rid, None)
            self._drop(sock)
            raise BackplaneError(
                f"bulk ingest connection lost: {e}") from e
        return (rid, waiter, timeout_s)

    def review_bulk_finish(self, ticket: tuple) -> list[bytes]:
        """Wait out one `review_bulk_begin` ticket and parse its
        reply. Raises BackplaneError on loss or timeout."""
        rid, waiter, timeout_s = ticket
        if not waiter.event.wait((timeout_s or 30.0) + 5.0):
            with self._pending_lock:
                self._pending.pop(rid, None)
            raise BackplaneError("bulk ingest timed out")
        if waiter.status < 0:
            raise BackplaneError("bulk ingest connection lost")
        if waiter.status != 200:
            raise BackplaneError(
                f"bulk ingest refused ({waiter.status}): "
                f"{bytes(waiter.body)[:200].decode('utf-8', 'replace')}")
        body = bytes(waiter.body)
        (count,) = _B_LEN.unpack_from(body, 0)
        off = _B_LEN.size
        outs = []
        for _ in range(count):
            (n,) = _B_LEN.unpack_from(body, off)
            off += _B_LEN.size
            outs.append(body[off:off + n])
            off += n
        return outs


# ----------------------------------------------------------------- router


class BackplaneRouter:
    """Frontend-side fan-in over N engine sockets: one multiplexed
    BackplaneClient per engine. Routing: least in-flight forwards
    first; ties break on the request hash (stable spread under equal
    load); an engine that fails mid-call (died, wedged, unreachable)
    fails over to the next-best engine — each tried at most once — so
    one killed engine costs its in-flight requests one retry, not a
    stance answer, and the burst keeps completing on the survivors.

    Drop-in for BackplaneClient where the FrontendServer is concerned
    (call / send_stats / connected / close)."""

    def __init__(self, socket_paths, worker_id: str = "0",
                 connect_timeout: float = 1.0, ring_mb: float = 0.0,
                 ring_prefix: str = ""):
        paths = list(socket_paths)
        if not paths:
            raise ValueError("router needs at least one engine socket")
        # one ring pair per ENGINE connection (each engine process maps
        # its own pair); names stay unique per (worker, engine index)
        base = ring_prefix or f"gk-bp-{os.getpid()}-{worker_id}"
        self.clients = [BackplaneClient(p, worker_id=worker_id,
                                        connect_timeout=connect_timeout,
                                        ring_mb=ring_mb,
                                        ring_prefix=f"{base}-e{i}")
                        for i, p in enumerate(paths)]

    @property
    def stats_hook(self):
        return self.clients[0].stats_hook

    @stats_hook.setter
    def stats_hook(self, fn) -> None:
        for c in self.clients:
            c.stats_hook = fn

    @property
    def stage_hook(self):
        return self.clients[0].stage_hook

    @stage_hook.setter
    def stage_hook(self, fn) -> None:
        for c in self.clients:
            c.stage_hook = fn

    def ring_fill(self) -> Optional[float]:
        fills = [f for f in (c.ring_fill() for c in self.clients)
                 if f is not None]
        return max(fills) if fills else None

    def connected(self) -> bool:
        return any(c.connected() for c in self.clients)

    def ensure_connected(self) -> None:
        for c in self.clients:
            try:
                c.ensure_connected()
            except BackplaneError:
                pass  # that engine retries lazily on first forward

    def close(self) -> None:
        for c in self.clients:
            c.close()

    def inflight(self) -> int:
        return sum(c.inflight() for c in self.clients)

    def call(self, path: str, body: bytes, timeout_s: float,
             deadline: float,
             trace_ctx: Optional[tuple] = None) -> tuple[int, bytes]:
        clients = self.clients
        if path.startswith("/v1/preview"):
            # previews pin to the PRIMARY (engine 0): it owns the live
            # tracker-fed inventory; pinned engine children only hold
            # sync-time snapshots. No failover — a preview is not an
            # admission verdict, an error answer is fine.
            status, out = clients[0].call(path, body, timeout_s,
                                          deadline, trace_ctx=trace_ctx)
            if status == STATUS_NOT_READY:
                raise BackplaneError("engine awaiting library sync")
            return status, out
        if len(clients) == 1:
            status, out = clients[0].call(path, body, timeout_s,
                                          deadline,
                                          trace_ctx=trace_ctx)
            if status == STATUS_NOT_READY:
                # no synced engine to fail over to: the frontend
                # answers per the failure stance
                raise BackplaneError("engine awaiting library sync")
            return status, out
        import zlib

        h = zlib.crc32(body) % len(clients)
        order = sorted(range(len(clients)),
                       key=lambda k: (clients[k].inflight(),
                                      (k - h) % len(clients)))
        err: Optional[BackplaneError] = None
        for k in order:
            try:
                status, out = clients[k].call(path, body, timeout_s,
                                              deadline,
                                              trace_ctx=trace_ctx)
            except BackplaneError as e:
                err = e  # next engine; the burst must not drop
                continue
            if status == STATUS_NOT_READY:
                # a respawned engine awaiting its library sync: a
                # synced engine must answer instead
                err = BackplaneError("engine awaiting library sync")
                continue
            return status, out
        raise err if err is not None else BackplaneError("no engines")

    def send_stats(self, stats: dict) -> None:
        # stats go to the PRIMARY engine (index 0 — the process whose
        # registry is scraped); fall back to any connected engine so a
        # dead primary does not silently eat the deltas forever
        for c in self.clients:
            if c.connected():
                c.send_stats(stats)
                return


# --------------------------------------------------------------- frontend


class _StatsAccumulator:
    """Forward-latency histogram + failure-stance counter + per-stage
    span-duration histograms (sampled requests only), accumulated
    locally and shipped to the engine as periodic deltas."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = [0] * (len(STATS_BUCKETS) + 1)
        self._sum = 0.0
        self._n = 0
        self._errors = 0
        # stage -> [bucket_counts, sum, n] over metrics.STAGE_BUCKETS:
        # the frontend-side spans of SAMPLED requests, merged into
        # gatekeeper_tpu_stage_duration_seconds engine-side
        self._stages: dict[str, list] = {}
        # shm-ring path counts ("ring" forwarded as a descriptor,
        # "inline" fell back) -> gatekeeper_tpu_backplane_ring_total
        self._ring: dict[str, int] = {}

    def observe(self, seconds: float) -> None:
        with self._lock:
            _bucket_observe(self._counts, STATS_BUCKETS, seconds)
            self._sum += seconds
            self._n += 1

    def observe_stage(self, stage: str, seconds: float) -> None:
        with self._lock:
            ent = self._stages.get(stage)
            if ent is None:
                ent = self._stages[stage] = [
                    [0] * (len(STAGE_BUCKETS) + 1), 0.0, 0]
            _bucket_observe(ent[0], STAGE_BUCKETS, seconds)
            ent[1] += seconds
            ent[2] += 1

    def error(self) -> None:
        with self._lock:
            self._errors += 1

    def ring_path(self, path: str) -> None:
        with self._lock:
            self._ring[path] = self._ring.get(path, 0) + 1

    def drain(self, worker: str) -> Optional[dict]:
        with self._lock:
            if not self._n and not self._errors and not self._stages \
                    and not self._ring:
                return None
            out = {"worker": worker, "buckets": self._counts,
                   "sum": round(self._sum, 6), "count": self._n,
                   "errors": self._errors}
            if self._stages:
                out["stages"] = {
                    stage: {"buckets": ent[0],
                            "sum": round(ent[1], 6), "count": ent[2]}
                    for stage, ent in self._stages.items()}
                self._stages = {}
            if self._ring:
                out["ring_paths"] = self._ring
                self._ring = {}
            self._counts = [0] * (len(STATS_BUCKETS) + 1)
            self._sum = 0.0
            self._n = 0
            self._errors = 0
            return out


class FrontendServer:
    """One pre-forked HTTP frontend: accept + TLS + header parse, then
    forward the body bytes over the backplane. Never JSON-decodes a
    review on the hot path (the failure stance parses lazily, only to
    recover the uid)."""

    def __init__(self, client: BackplaneClient, port: int = 8443,
                 addr: str = "", certfile: Optional[str] = None,
                 keyfile: Optional[str] = None, reuse_port: bool = True,
                 serve: tuple = ("admit", "admitlabel", "mutate"),
                 fail_closed: bool = False,
                 mutation_fail_closed: Optional[bool] = None,
                 default_timeout: float = DEFAULT_WEBHOOK_TIMEOUT_S,
                 worker_id: str = "0"):
        from .webhook import FastHTTPServer

        self.client = client
        self.serve = frozenset(serve)
        self.fail_closed = fail_closed
        self.mutation_fail_closed = (fail_closed if mutation_fail_closed
                                     is None else mutation_fail_closed)
        self.default_timeout = default_timeout
        self.worker_id = worker_id
        self.stats = _StatsAccumulator()
        # the client reports ring-path usage and sampled ring_write
        # durations into this frontend's stats accumulator (both ride
        # the S-frame deltas to the engine's registry)
        client.stats_hook = self.stats.ring_path
        client.stage_hook = self.stats.observe_stage
        self.http = FastHTTPServer((addr, port), self._dispatch,
                                   reuse_port=reuse_port,
                                   certfile=certfile, keyfile=keyfile)
        self.server = self.http.server
        self.port = self.http.port
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        name="frontend", daemon=True)
        self._last_inflight = 0
        self._stats_stop = threading.Event()
        self._stats_thread = threading.Thread(
            target=self._stats_loop, name="frontend-stats", daemon=True)

    # request path ---------------------------------------------------

    def _route(self, path: str) -> Optional[str]:
        route = route_path(path)
        return route if route in self.serve else None

    def _dispatch(self, path: str, body: bytes,
                  traceparent: Optional[str] = None) -> tuple:
        t_recv = time.monotonic()
        route = self._route(path)
        if route is None:
            # un-served endpoints 404 LOCALLY: no backplane hop for an
            # operation the operator turned off
            return 404, b""
        # the frontend is the sampling edge: it decides, forwards the
        # span context over the Q frame, and answers X-Trace-Id. The
        # engine owns the flight recorder; the frontend only ships its
        # own two stages as aggregated S-frame deltas.
        tid = gtrace.TRACER.sample_context(traceparent)
        timeout_s = parse_timeout_query(path.partition("?")[2]) or 0.0
        if route == "preview":
            # a cold preview may legitimately wait out an XLA compile;
            # its wait is its own, not an admission budget
            deadline = time.monotonic() + (timeout_s or 300.0)
        elif timeout_s > 0:
            deadline = request_deadline({"timeoutSeconds": timeout_s},
                                        self.default_timeout)
        else:
            # no query budget: the frontend cannot see a body-carried
            # timeoutSeconds without parsing, so its WAIT is only a
            # backstop at the API server's maximum webhook budget — the
            # engine enforces the real (possibly longer-than-default)
            # deadline and answers per stance before it
            deadline = time.monotonic() + MAX_WEBHOOK_TIMEOUT_S
        t0 = time.monotonic()
        try:
            status, payload = self.client.call(
                path, body, timeout_s, deadline,
                trace_ctx=None if tid is None else (tid, t_recv))
            now = time.monotonic()
            self.stats.observe(now - t0)
            if tid is None:
                return status, payload
            # ship ONLY the stage this process truly owns: the forward
            # hop and every engine stage are timed (and histogrammed)
            # engine-side — shipping the call round trip as a stage
            # would re-count all of them under one label
            self.stats.observe_stage("frontend_parse", t0 - t_recv)
            return status, payload, {"X-Trace-Id": tid}
        except BackplaneError as e:
            self.stats.error()
            if route == "preview":
                # not an admission verdict: a plain error, no stance
                out = 503, jsonio.dumps_bytes({"error": str(e)})
            else:
                out = 200, self._stance_envelope(route, body, str(e))
            # a stance answer still reports its trace id: the id is in
            # the caller's hands (and logs) even though the engine
            # never saw the request
            return out if tid is None else (*out, {"X-Trace-Id": tid})

    def _stance_envelope(self, route: str, body: bytes,
                         message: str) -> bytes:
        """The failure-stance verdict a frontend issues on its own when
        the engine cannot: fail-open allows with a warning status,
        fail-closed denies. Parses the review ONLY here, to echo uid
        and envelope apiVersion/kind."""
        uid = ""
        api_version = kind = None
        try:
            review = jsonio.loads(body)
            if isinstance(review, dict):
                uid = (review.get("request") or {}).get("uid") or ""
                api_version = review.get("apiVersion")
                kind = review.get("kind")
        except ValueError:
            pass
        fail_closed = (self.mutation_fail_closed if route == "mutate"
                       else self.fail_closed)
        return encode_envelope({
            "apiVersion": api_version or "admission.k8s.io/v1beta1",
            "kind": kind or "AdmissionReview",
            "response": {"uid": uid, "allowed": not fail_closed,
                         "status": {"code": 503, "message": message}},
        })

    # lifecycle ------------------------------------------------------

    def start(self) -> None:
        self._thread.start()
        self._stats_thread.start()

    def _stats_loop(self) -> None:
        while not self._stats_stop.wait(STATS_INTERVAL_S):
            stats = self.stats.drain(self.worker_id)
            inflight = self.client.inflight()
            if stats is None:
                if not inflight and self._last_inflight == 0:
                    continue  # nothing moved; skip the frame
                stats = {"worker": self.worker_id}
            stats["inflight"] = inflight
            self._last_inflight = inflight
            fill = getattr(self.client, "ring_fill", lambda: None)()
            if fill is not None:
                stats["ring_fill"] = round(fill, 4)
            self.client.send_stats(stats)

    def stop(self, drain_timeout: float = 10.0) -> None:
        """Frontend drain: stop accepting, finish in-flight HTTP
        requests (their verdicts are already in flight on the
        backplane), close."""
        self.server.shutdown()
        end = time.monotonic() + drain_timeout
        while time.monotonic() < end:
            if self.http.inflight() == 0:
                break
            time.sleep(0.02)
        self._stats_stop.set()
        self.client.close()
        self.server.server_close()


# ------------------------------------------------------------- supervisor


REAP_TIMEOUT_S = 10.0


def _reap_failed_start(procs, what: str) -> None:
    """Kill and wait, REAP_TIMEOUT_S each, for every child of a start
    that failed: a child that raised before READY may still be tearing
    down its interpreter when its stdout closes, and a start that
    returns must leave no live or unreaped child behind (child_pids is
    the leak baseline)."""
    for proc in procs:
        if proc is not None and proc.poll() is None:
            proc.kill()
    for proc in procs:
        if proc is None:
            continue
        try:
            proc.wait(REAP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            log.warning("failed start: child outlived its kill",
                        details={"child": what, "pid": proc.pid,
                                 "timeout_s": REAP_TIMEOUT_S})


class FrontendSupervisor:
    """Pre-forks N frontend processes (this module's __main__), binds
    them all to one SO_REUSEPORT port, respawns crashed children, and
    drains them BEFORE the engine on shutdown."""

    def __init__(self, n: int, socket_path, port: int = 8443,
                 addr: str = "", certfile: Optional[str] = None,
                 keyfile: Optional[str] = None,
                 serve: tuple = ("admit", "admitlabel", "mutate"),
                 fail_closed: bool = False,
                 mutation_fail_closed: Optional[bool] = None,
                 default_timeout: float = DEFAULT_WEBHOOK_TIMEOUT_S,
                 ready_timeout: float = 30.0,
                 trace_sample_rate: float = 0.0,
                 shm_ring_mb: float = 8.0):
        self.n = n
        self.trace_sample_rate = trace_sample_rate
        # shared-memory ring size per frontend (MB); 0 disables the
        # rings and every review rides inline frames
        self.shm_ring_mb = shm_ring_mb
        # one socket (single engine) or a list (the N-engine plane:
        # each frontend connects to every engine and routes)
        if not isinstance(socket_path, str):
            socket_path = ",".join(socket_path)
        self.socket_path = socket_path
        self.addr = addr
        self.certfile = certfile
        self.keyfile = keyfile
        self.serve = tuple(serve)
        self.fail_closed = fail_closed
        self.mutation_fail_closed = mutation_fail_closed
        self.default_timeout = default_timeout
        self.ready_timeout = ready_timeout
        self.port = port
        self._holder: Optional[socket.socket] = None
        if port == 0:
            # ephemeral port: hold a bound (non-listening) SO_REUSEPORT
            # socket so the chosen port survives until every child has
            # bound it; the kernel only balances across LISTENING
            # sockets, so the placeholder never receives connections
            self._holder = socket.socket()
            self._holder.setsockopt(socket.SOL_SOCKET,
                                    socket.SO_REUSEPORT, 1)
            self._holder.bind((addr or "127.0.0.1", 0))
            self.port = self._holder.getsockname()[1]
        self._procs: list[Optional[subprocess.Popen]] = [None] * n
        self._stopping = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        # gray-failure liveness: frontends print an HB line on stdout
        # every second (frontend_main); the per-slot reader thread
        # stamps arrival times here and the monitor loop declares a
        # child WEDGED — alive but silent past the deadline — and
        # SIGKILLs it onto the ordinary respawn path. Death-only
        # detection (waitpid) misses a SIGSTOP'd/hung frontend, which
        # holds its SO_REUSEPORT share and blackholes its connections.
        self.heartbeat_deadline_s = 10.0
        self._hb: dict[int, float] = {}
        # crash-loop rate limiting + MTTR accounting
        self._backoff = liveness.Backoff("frontend")
        self._spawned_at: dict[int, float] = {}
        self._respawn_at: dict[int, float] = {}
        self._detected: dict[int, tuple] = {}  # k -> (t_detect, fault)

    def _ring_prefix(self, k: int) -> str:
        # deterministic per worker SLOT (not per child pid): the
        # supervisor can sweep a SIGKILLed child's stale segments
        # before handing the name to its replacement
        return f"gk-bp-{os.getpid()}-w{k}"

    def _sweep_rings(self, k: int) -> None:
        prefix = self._ring_prefix(k)
        shm.sweep_stale(prefix)
        # router mode: one ring pair per engine connection
        for i in range(len(self.socket_path.split(","))):
            shm.sweep_stale(f"{prefix}-e{i}")

    def _spawn(self, k: int) -> subprocess.Popen:
        self._sweep_rings(k)
        cmd = [sys.executable, "-m", "gatekeeper_tpu_torch.control.backplane",
               "--socket", self.socket_path,
               "--port", str(self.port),
               "--addr", self.addr,
               "--worker-id", str(k),
               "--serve", ",".join(self.serve),
               "--default-timeout", str(self.default_timeout),
               "--trace-sample-rate", str(self.trace_sample_rate),
               "--shm-ring-mb", str(self.shm_ring_mb),
               "--shm-ring-name", self._ring_prefix(k)]
        if self.certfile:
            cmd += ["--certfile", self.certfile]
            if self.keyfile:
                cmd += ["--keyfile", self.keyfile]
        if self.fail_closed:
            cmd += ["--fail-closed"]
        if self.mutation_fail_closed is not None:
            # explicit true/false: collapsing False into "unset" would
            # make the frontend inherit the VALIDATING stance for
            # mutations, flipping an operator's fail-open override
            cmd += ["--mutation-fail-closed",
                    "true" if self.mutation_fail_closed else "false"]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)

    def start(self) -> None:
        try:
            for k in range(self.n):
                self._procs[k] = self._spawn(k)
            deadline = time.monotonic() + self.ready_timeout
            for k, proc in enumerate(self._procs):
                self._await_ready(k, proc, deadline)
        except Exception:
            # a worker that never came up must not leak its siblings
            self._stopping.set()
            _reap_failed_start(self._procs, "admission frontend")
            raise
        if self._holder is not None:
            self._holder.close()
            self._holder = None
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="frontend-supervisor",
                                         daemon=True)
        self._monitor.start()
        log.info("admission frontends serving",
                 details={"workers": self.n, "port": self.port})

    def _await_ready(self, k: int, proc: subprocess.Popen,
                     deadline: float) -> None:
        line: list = []

        def read():
            line.append(proc.stdout.readline())

        t = threading.Thread(target=read, daemon=True)
        t.start()
        t.join(max(0.1, deadline - time.monotonic()))
        if not line or "READY" not in (line[0] or ""):
            raise RuntimeError(
                f"admission frontend {k} failed to start")
        # reader thread for the child's remaining stdout: keeps the
        # pipe from ever filling (the old full-read drain's job) AND
        # stamps every line — the 1/s HB lines above all — as this
        # slot's liveness heartbeat
        self._hb[k] = time.monotonic()
        self._spawned_at[k] = time.monotonic()
        threading.Thread(target=self._pump_heartbeats, args=(k, proc),
                         daemon=True).start()

    def _pump_heartbeats(self, k: int, proc: subprocess.Popen) -> None:
        try:
            for _ in proc.stdout:
                self._hb[k] = time.monotonic()
        except (OSError, ValueError):
            pass  # child died / pipe closed: poll() takes it from here

    def _monitor_loop(self) -> None:
        while not self._stopping.wait(0.5):
            now = time.monotonic()
            for k, proc in enumerate(self._procs):
                if proc is None or self._stopping.is_set():
                    continue
                dead = proc.poll() is not None
                if not dead and k not in self._detected \
                        and now - self._hb.get(k, now) \
                        > self.heartbeat_deadline_s:
                    # gray failure: the process is alive but has not
                    # written a heartbeat past the deadline (SIGSTOP,
                    # hung accept loop). SIGKILL it; the respawn path
                    # below heals it like any crash.
                    log.warning(
                        "admission frontend wedged (no heartbeat); "
                        "killing",
                        details={"worker": k,
                                 "hb_age_s":
                                     round(now - self._hb[k], 2)})
                    self._detected[k] = (now, "wedge")
                    try:
                        proc.kill()
                        proc.wait(5.0)
                    except (OSError, subprocess.TimeoutExpired):
                        pass
                    dead = proc.poll() is not None
                if not dead:
                    if self._backoff.pending(k) \
                            and now - self._spawned_at.get(k, now) \
                            >= self._backoff.healthy_after:
                        self._backoff.note_healthy(k)
                    continue
                if k not in self._detected:
                    log.warning("admission frontend died; respawning",
                                details={"worker": k,
                                         "rc": proc.returncode})
                    self._detected[k] = (now, "death")
                    uptime = now - self._spawned_at.get(k, now)
                    delay = self._backoff.delay_for(k, uptime)
                    self._respawn_at[k] = now + delay
                if now < self._respawn_at.get(k, now):
                    continue  # holding the crash-loop backoff delay
                p = None
                try:
                    p = self._spawn(k)
                    self._await_ready(
                        k, p, time.monotonic() + self.ready_timeout)
                    self._procs[k] = p
                    self._backoff.respawned(k)
                    self._respawn_at.pop(k, None)
                    t0, fault = self._detected.pop(k, (now, "death"))
                    from . import metrics as _metrics
                    _metrics.report_fault_recovery(
                        "frontend", fault, time.monotonic() - t0)
                except Exception as e:
                    log.error("frontend respawn failed",
                              details={"worker": k, "error": str(e)})
                    # never leak a half-started child: it may hold
                    # the SO_REUSEPORT bind and receive live
                    # connections while untracked
                    if p is not None:
                        try:
                            p.kill()
                        except OSError:
                            pass
                    # the failed attempt counts as another fast death
                    # for the backoff ladder
                    self._respawn_at[k] = time.monotonic() + \
                        self._backoff.delay_for(k, 0.0)

    def alive(self) -> bool:
        return all(p is not None and p.poll() is None
                   for p in self._procs)

    # chaos hooks ----------------------------------------------------

    def child_pids(self) -> dict[int, int]:
        """Live child pids by worker slot (the chaos verifier's
        process-leak baseline)."""
        return {k: p.pid for k, p in enumerate(self._procs)
                if p is not None and p.poll() is None}

    def kill_child(self, k: int) -> None:
        """Chaos hook: SIGKILL one frontend (the monitor respawns it;
        the kernel re-balances its SO_REUSEPORT share meanwhile)."""
        proc = self._procs[k] if 0 <= k < len(self._procs) else None
        if proc is not None and proc.poll() is None:
            proc.kill()

    def pause_child(self, k: int) -> None:
        """Chaos hook: SIGSTOP one frontend — alive to waitpid, silent
        on the wire. Only the heartbeat deadline can catch this."""
        proc = self._procs[k] if 0 <= k < len(self._procs) else None
        if proc is not None and proc.poll() is None:
            proc.send_signal(signal.SIGSTOP)

    def resume_child(self, k: int) -> None:
        proc = self._procs[k] if 0 <= k < len(self._procs) else None
        if proc is not None and proc.poll() is None:
            proc.send_signal(signal.SIGCONT)

    def stop(self, timeout: float = 15.0) -> None:
        """SIGTERM every frontend (each drains its in-flight HTTP
        requests) and wait — the engine drains only after this
        returns."""
        self._stopping.set()
        for proc in self._procs:
            if proc is not None and proc.poll() is None:
                try:
                    # a SIGSTOP'd child (chaos pause) cannot handle
                    # SIGTERM while stopped: resume it first so it can
                    # drain; SIGCONT on a running child is a no-op
                    os.kill(proc.pid, signal.SIGCONT)
                    proc.terminate()
                except OSError:
                    pass
        end = time.monotonic() + timeout
        for proc in self._procs:
            if proc is None:
                continue
            try:
                proc.wait(max(0.1, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                try:  # reap: an unwaited kill leaves a zombie that
                    proc.wait(5.0)  # still answers os.kill(pid, 0)
                except subprocess.TimeoutExpired:
                    pass
        if self._holder is not None:
            self._holder.close()
            self._holder = None
        self._backoff.close()
        # a gracefully-exited frontend unlinked its own rings; sweep
        # anyway so a kill -9'd child cannot leak /dev/shm segments
        for k in range(self.n):
            self._sweep_rings(k)


# ------------------------------------------------------ engine supervisor


class EngineSupervisor:
    """Spawns the N-1 admission ENGINE child processes of the N-engine
    plane (engine 0 stays in the primary process), one per chip —
    `python -m gatekeeper_tpu_torch.control.engine --engine-id k --device k`
    — monitors and respawns them, replicates every library mutation to
    each over L frames (a freshly (re)spawned or replication-failed
    engine gets a FULL sync first), and polls per-engine metric totals
    over M frames, merging the deltas into this process's registry so
    shed accounting / decision counts / cache outcomes stay global on
    the primary's /metrics."""

    POLL_INTERVAL_S = 2.0
    # labels for the recovery histogram / backoff gauges; the audit
    # subclass overrides both
    RECOVERY_COMPONENT = "engine"
    SUPERVISOR_LABEL = "engine"

    def __init__(self, engine_ids, socket_for, spawn_args=(),
                 snapshot_provider=None, ready_timeout: float = 180.0,
                 heartbeat_deadline_s: float = 10.0):
        self.engine_ids = list(engine_ids)
        self.socket_for = socket_for          # engine id -> socket path
        self.spawn_args = list(spawn_args)    # passthrough CLI flags
        self.snapshot_provider = snapshot_provider  # () -> full sync op
        self.ready_timeout = ready_timeout
        self._procs: dict[int, Optional[subprocess.Popen]] = \
            {k: None for k in self.engine_ids}
        self._ctl: dict[int, BackplaneClient] = {}
        self._dirty: dict[int, bool] = {k: True for k in self.engine_ids}
        self._prev_stats: dict[int, dict] = {}
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        # gray-failure liveness: the M-frame stats poll doubles as the
        # heartbeat — a child that is alive to waitpid but has not
        # ANSWERED a poll (or resync) within this deadline is wedged
        # (SIGSTOP, spinning, hung device) and gets SIGKILLed onto the
        # ordinary respawn+resync path. Must comfortably exceed
        # POLL_INTERVAL_S plus the poll timeout.
        self.heartbeat_deadline_s = heartbeat_deadline_s
        self._last_ok: dict[int, float] = {}
        # stamped before each poll; a child is only wedged if a poll
        # was ATTEMPTED after its last answer — polls are serialized,
        # so one wedged sibling stalling its 5 s poll timeout must not
        # age a healthy (simply not-yet-re-polled) child past the
        # deadline and get it falsely killed
        self._last_attempt: dict[int, float] = {}
        # crash-loop rate limiting + MTTR accounting
        self._backoff = liveness.Backoff(self.SUPERVISOR_LABEL)
        self._spawned_at: dict[int, float] = {}
        self._respawn_at: dict[int, float] = {}
        self._detected: dict[int, tuple] = {}  # k -> (t_detect, fault)
        # fan-out actuation (adaptive controller): how many children
        # should be RUNNING. Children beyond the prefix are "parked" —
        # terminated and not respawned until the count rises again.
        # The configured engine_ids list stays the hard ceiling.
        self._desired_children = len(self.engine_ids)
        # serving-knob replication: the latest set_knobs() payload and
        # a generation counter; the monitor loop pushes it to every
        # synced child and re-pushes after each respawn/resync
        self._knobs: Optional[dict] = None
        self._knobs_gen = 0
        self._knobs_pushed: dict[int, int] = {}

    # spawn / readiness ----------------------------------------------

    def engine_label(self, k: int) -> str:
        """The `engine=` label this child relays its stats under; gauge
        zeroing on park/death/stop must target the SAME string or a
        dead child's duty/depth series outlives it."""
        return str(k)

    def _spawn(self, k: int) -> subprocess.Popen:
        cmd = [sys.executable, "-m", "gatekeeper_tpu_torch.control.engine",
               "--socket", self.socket_for(k),
               "--engine-id", str(k),
               "--device", str(k)] + self.spawn_args
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)

    def _await_ready(self, k: int, proc: subprocess.Popen,
                     deadline: float) -> None:
        line: list = []

        def read():
            line.append(proc.stdout.readline())

        t = threading.Thread(target=read, daemon=True)
        t.start()
        t.join(max(0.1, deadline - time.monotonic()))
        if not line or "READY" not in (line[0] or ""):
            raise RuntimeError(f"admission engine {k} failed to start")
        # liveness stamps: the child just proved it can talk; the
        # heartbeat deadline measures from here until its first
        # answered poll
        self._spawned_at[k] = self._last_ok[k] = time.monotonic()
        threading.Thread(target=lambda: proc.stdout.read(),
                         daemon=True).start()

    def start(self) -> None:
        try:
            deadline = time.monotonic() + self.ready_timeout
            for k in self.engine_ids:
                self._procs[k] = self._spawn(k)
            for k in self.engine_ids:
                self._await_ready(k, self._procs[k], deadline)
        except Exception:
            self._stopping.set()
            _reap_failed_start(list(self._procs.values()),
                               "admission engine")
            raise
        for k in self.engine_ids:
            self._ctl[k] = BackplaneClient(self.socket_for(k),
                                           worker_id=f"ctl-{k}",
                                           connect_timeout=5.0)
            self._resync(k)
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="engine-supervisor",
                                         daemon=True)
        self._monitor.start()
        log.info("admission engines serving",
                 details={"engines": 1 + len(self.engine_ids)})

    # library replication --------------------------------------------

    def _resync(self, k: int) -> None:
        """Full library sync to one engine (boot, respawn, or heal
        after a failed incremental op). A sync that itself fails keeps
        the engine dirty; the monitor loop retries.

        The lock makes (clear dirty, snapshot, send) atomic with
        respect to replicate(): without it, an op landing between the
        snapshot and the sync SEND could replicate first and then be
        REMOVED by the sync's drop-extras reconciliation (built from
        the pre-op snapshot) — a permanently lost mutation on that
        engine. Under the lock every racing op sends after the sync
        frame on the ordered control stream, so it re-applies; an op
        the snapshot already caught applies twice, which the clients'
        semantic-equal dedupe absorbs."""
        provider = self.snapshot_provider
        if provider is None:
            self._dirty[k] = False
            return
        with self._lock:
            self._dirty[k] = False
            try:
                op = provider()
                op["op"] = "sync"
                self._ctl[k].control(op, timeout=120.0)
                self._last_ok[k] = time.monotonic()
                log.info("engine resynced", details={"engine": k})
            except Exception as e:
                self._dirty[k] = True
                log.warning("engine resync failed; will retry",
                            details={"engine": k, "error": str(e)})

    def replicate(self, op: str, obj) -> None:
        """Fan one library mutation out to every engine child (the
        primary's own client already applied it). Called from the
        Client's on_change observer — failures mark the engine dirty
        for a monitor-loop resync, they never raise into ingestion.
        Serialized against _resync by the lock (see there)."""
        msg = {"op": op, "obj": obj}
        with self._lock:
            for k in self.engine_ids:
                ctl = self._ctl.get(k)
                if ctl is None or self._dirty.get(k):
                    continue  # resync (which includes this op) pending
                try:
                    ctl.control(msg)
                except BackplaneError as e:
                    self._dirty[k] = True
                    log.warning("library replication failed; engine "
                                "marked for resync",
                                details={"engine": k, "error": str(e)})

    # fan-out / knob actuation ---------------------------------------

    def scale_to(self, total: int) -> int:
        """Desired TOTAL engine count, primary included (the adaptive
        controller's fan-out actuator). Clamped to [1, configured].
        NON-BLOCKING: this only records the target — the monitor loop
        parks (terminates, stops respawning) children beyond it and
        unparks (respawns + resyncs) them when it rises. Returns the
        clamped total."""
        want = min(1 + len(self.engine_ids), max(1, int(total)))
        self._desired_children = want - 1
        return want

    def active_total(self) -> int:
        """Desired total engine count (primary + unparked children)."""
        return 1 + self._desired_children

    def _active_ids(self) -> set:
        return set(self.engine_ids[: self._desired_children])

    def set_knobs(self, knobs: dict) -> None:
        """Queue a serving-knob update (MicroBatcher max_wait /
        max_batch / max_queue share) for every engine child.
        NON-BLOCKING: the monitor loop pushes the newest payload over
        each child's control stream, and re-pushes after any respawn,
        so a healed engine never serves with stale knobs."""
        with self._lock:
            self._knobs = dict(knobs)
            self._knobs_gen += 1

    def _push_knobs(self) -> None:
        """Send the newest knob payload to synced children that have
        not acknowledged this generation. A send failure just leaves
        the child un-acked for the next pass — knob pushes are
        idempotent, unlike library ops, so no dirty/resync machinery."""
        with self._lock:
            knobs, gen = self._knobs, self._knobs_gen
        if knobs is None:
            return
        for k in self.engine_ids:
            if self._knobs_pushed.get(k) == gen:
                continue
            ctl = self._ctl.get(k)
            if ctl is None or self._dirty.get(k):
                continue
            try:
                ctl.control({"op": "knobs", "obj": knobs})
                self._knobs_pushed[k] = gen
            except BackplaneError as e:
                log.warning("knob replication failed; will retry",
                            details={"engine": k, "error": str(e)})

    # monitor / stats ------------------------------------------------

    def _monitor_loop(self) -> None:
        last_poll = 0.0
        while not self._stopping.wait(0.5):
            active = self._active_ids()
            now = time.monotonic()
            # gray-failure pass: a child that is ALIVE to waitpid but
            # has not answered a stats poll or resync within the
            # heartbeat deadline is WEDGED (SIGSTOP'd, spinning, hung
            # on its device) — death-only detection would leave it
            # holding its socket while frontends pile failovers onto
            # survivors. SIGKILL it; the respawn pass below heals it
            # like any crash.
            for k in self.engine_ids:
                if k not in active or k in self._detected:
                    continue
                proc = self._procs.get(k)
                if proc is None or proc.poll() is not None:
                    continue
                last_ok = self._last_ok.get(k, now)
                age = now - last_ok
                if age > self.heartbeat_deadline_s \
                        and self._last_attempt.get(k, 0.0) > last_ok:
                    log.warning(
                        "engine child wedged (no poll answer); "
                        "killing",
                        details={"engine": k,
                                 "supervisor": self.SUPERVISOR_LABEL,
                                 "poll_age_s": round(age, 2)})
                    self._detected[k] = (now, "wedge")
                    try:
                        proc.kill()
                        proc.wait(5.0)
                    except (OSError, subprocess.TimeoutExpired):
                        pass
                elif self._backoff.pending(k) \
                        and now - self._spawned_at.get(k, now) \
                        >= self._backoff.healthy_after:
                    self._backoff.note_healthy(k)
            # park pass: children beyond the desired fan-out stop
            # (graceful terminate -> batcher drain) and stay down; the
            # frontends' router fails their sockets over to survivors
            for k in self.engine_ids:
                if k in active:
                    continue
                proc = self._procs.get(k)
                if proc is None or proc.poll() is not None:
                    continue
                log.info("admission engine parked (scale-down)",
                         details={"engine": k})
                old = self._ctl.pop(k, None)
                if old is not None:
                    old.close()
                self._prev_stats.pop(k, None)
                self._knobs_pushed.pop(k, None)
                # a park mid-recovery cancels the recovery: down on
                # purpose now, not a fault being healed
                self._detected.pop(k, None)
                self._respawn_at.pop(k, None)
                from . import metrics as _metrics
                _metrics.zero_engine_gauges(self.engine_label(k))
                try:
                    proc.terminate()
                except OSError:
                    pass
            # two-pass respawn: spawn EVERY dead engine first, then
            # await readiness — concurrently-dead engines initialize
            # in parallel instead of head-of-line blocking on one
            # child's (potentially slow) JAX/device init
            spawned: list = []
            for k in self.engine_ids:
                if k not in active:
                    continue  # parked: dead on purpose, no respawn
                proc = self._procs.get(k)
                if proc is None or proc.poll() is None \
                        or self._stopping.is_set():
                    continue
                now = time.monotonic()
                if k not in self._detected:
                    log.warning("admission engine died; respawning",
                                details={"engine": k,
                                         "rc": proc.returncode,
                                         "supervisor":
                                             self.SUPERVISOR_LABEL})
                    self._detected[k] = (now, "death")
                if k not in self._respawn_at:
                    uptime = now - self._spawned_at.get(k, now)
                    self._respawn_at[k] = \
                        now + self._backoff.delay_for(k, uptime)
                if now < self._respawn_at[k]:
                    continue  # holding the crash-loop backoff delay
                old = self._ctl.pop(k, None)
                if old is not None:
                    old.close()
                self._prev_stats.pop(k, None)
                # the replacement process boots with configured
                # defaults: forget any knob ack so the newest
                # payload re-pushes after its resync
                self._knobs_pushed.pop(k, None)
                # the dead child's relayed engine-labeled gauges
                # must not export its last depth/duty while it is
                # down (respawn's first poll would eventually
                # overwrite them — or never, if respawn keeps
                # failing)
                from . import metrics as _metrics
                _metrics.zero_engine_gauges(self.engine_label(k))
                try:
                    spawned.append((k, self._spawn(k)))
                except Exception as e:
                    log.error("engine respawn failed",
                              details={"engine": k,
                                       "error": str(e)})
                    self._respawn_at[k] = time.monotonic() + \
                        self._backoff.delay_for(k, 0.0)
            for k, p in spawned:
                try:
                    self._await_ready(
                        k, p, time.monotonic() + self.ready_timeout)
                    self._procs[k] = p
                    self._ctl[k] = BackplaneClient(
                        self.socket_for(k), worker_id=f"ctl-{k}",
                        connect_timeout=5.0)
                    self._dirty[k] = True
                    self._respawn_at.pop(k, None)
                    self._backoff.respawned(k)
                    # sync NOW, not next pass: the engine refuses
                    # admission (NOT_READY) until this lands, so the
                    # shorter the window the less failover traffic
                    # the survivors absorb
                    self._resync(k)
                except Exception as e:
                    log.error("engine respawn failed",
                              details={"engine": k, "error": str(e)})
                    # the dead proc stays in _procs[k]: retried next
                    # pass; never leak the half-started child
                    try:
                        p.kill()
                    except OSError:
                        pass
                    self._respawn_at[k] = time.monotonic() + \
                        self._backoff.delay_for(k, 0.0)
            for k in self.engine_ids:
                if self._dirty.get(k) and k in self._ctl:
                    self._resync(k)
            # recovery accounting: a detected-failed child counts as
            # recovered once its replacement is alive AND resynced —
            # the wall clock from detection to here is the MTTR the
            # fault_recovery histogram exports
            for k in list(self._detected):
                proc = self._procs.get(k)
                if proc is None or proc.poll() is not None \
                        or self._dirty.get(k) or k not in self._ctl:
                    continue
                t0, fault = self._detected.pop(k)
                self._respawn_at.pop(k, None)
                from . import metrics as _metrics
                _metrics.report_fault_recovery(
                    self.RECOVERY_COMPONENT, fault,
                    time.monotonic() - t0)
            self._push_knobs()
            now = time.monotonic()
            if now - last_poll >= self.POLL_INTERVAL_S:
                last_poll = now
                self.poll_stats()
                self._report_fleet()

    def _report_fleet(self) -> None:
        from . import metrics

        # "configured" follows the DESIRED fan-out, not the ceiling:
        # a deliberately parked engine must read as converged
        # (desired == alive), while a dead unparked one reads as a
        # deficit the monitor is healing
        metrics.report_admission_engines(
            self.active_total(), 1 + self.alive_count())

    def poll_stats(self) -> None:
        """Pull each engine's relayed metric totals and merge the
        delta since the previous poll into this process's registry."""
        from . import metrics

        for k in self.engine_ids:
            ctl = self._ctl.get(k)
            if ctl is None:
                continue
            self._last_attempt[k] = time.monotonic()
            try:
                # the poll timeout bounds wedge-detection latency (a
                # SIGSTOP'd child is only detectable once its poll
                # EXPIRES), so scale it with the heartbeat deadline
                # instead of always waiting the full production 5 s
                cur = ctl.poll_stats(timeout=min(
                    5.0, max(1.0, self.heartbeat_deadline_s)))
            except BackplaneError:
                continue  # dead/respawning engine: next pass
            # an answered poll IS the heartbeat: only a child whose
            # read loop is actually scheduling can produce one
            self._last_ok[k] = time.monotonic()
            metrics.merge_engine_stats(cur, self._prev_stats.get(k))
            self._prev_stats[k] = cur

    def alive_count(self) -> int:
        return sum(1 for p in self._procs.values()
                   if p is not None and p.poll() is None)

    def monitoring(self) -> bool:
        """The supervisor's health signal: the monitor thread is still
        respawning dead engines (NOT all-alive — a dead child mid-
        respawn is a degraded-but-serving state)."""
        t = self._monitor
        return bool(t and t.is_alive()) and not self._stopping.is_set()

    def alive(self) -> bool:
        # measured against the DESIRED fan-out: parked children are
        # down on purpose and must not read as a fleet deficit
        return self.alive_count() == self._desired_children

    def kill_engine(self, k: int) -> None:
        """Chaos hook: SIGKILL one engine child (the monitor respawns
        it; frontends fail its in-flight requests over to survivors)."""
        proc = self._procs.get(k)
        if proc is not None and proc.poll() is None:
            proc.kill()

    def pause_engine(self, k: int) -> None:
        """Chaos hook: SIGSTOP one engine child — alive to waitpid,
        silent on the wire. Only the poll-age heartbeat deadline can
        catch this (the gray-failure case)."""
        proc = self._procs.get(k)
        if proc is not None and proc.poll() is None:
            proc.send_signal(signal.SIGSTOP)

    def resume_engine(self, k: int) -> None:
        proc = self._procs.get(k)
        if proc is not None and proc.poll() is None:
            proc.send_signal(signal.SIGCONT)

    def child_pids(self) -> dict[int, int]:
        """Live child pids by engine id (the chaos verifier's
        process-leak baseline)."""
        return {k: p.pid for k, p in self._procs.items()
                if p is not None and p.poll() is None}

    def stop(self, timeout: float = 15.0) -> None:
        self._stopping.set()
        for ctl in self._ctl.values():
            ctl.close()
        self._ctl.clear()
        for proc in self._procs.values():
            if proc is not None and proc.poll() is None:
                try:
                    # resume a SIGSTOP'd child first — see
                    # FrontendSupervisor.stop
                    os.kill(proc.pid, signal.SIGCONT)
                    proc.terminate()
                except OSError:
                    pass
        end = time.monotonic() + timeout
        for proc in self._procs.values():
            if proc is None:
                continue
            try:
                proc.wait(max(0.1, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                try:
                    proc.wait(5.0)
                except subprocess.TimeoutExpired:
                    pass
        # stopped children's relayed engine-labeled gauges must not
        # outlive them on the primary's exposition
        from . import metrics
        for k in self.engine_ids:
            metrics.zero_engine_gauges(self.engine_label(k))
        self._backoff.close()


class AuditShardSupervisor(EngineSupervisor):
    """Spawns and supervises the N audit SHARD processes of the sharded
    inventory plane (`--serve auditslice`): same process-lifecycle,
    L-frame replication, and stats-merge machinery as the admission
    engines, plus

      * per-shard sync snapshots: the provider takes the shard id, so a
        respawned shard is refilled with ITS inventory slice (+ the
        join/namespace broadcast set), not the whole cluster;
      * a resync GENERATION per shard: bumped on every successful full
        sync, so the leader's sweep loop can tell "this shard was
        reborn since I last talked to it" and re-dispatch only the
        orphaned partition;
      * `sweep()`: the Q-frame request that runs one slice sweep on a
        shard's dedicated audit executor and returns its serialized
        per-kind results.

    Liveness rides the inherited M-frame poll-age heartbeat: slice
    sweeps run on the child's dedicated audit executor, so its read
    loop keeps answering polls through a multi-second sweep — only a
    genuinely wedged (SIGSTOP'd/hung) shard goes silent, gets killed,
    and is healed by respawn+resync; the leader's sweep retry then
    re-dispatches just the orphaned partition.
    """

    RECOVERY_COMPONENT = "audit_shard"
    SUPERVISOR_LABEL = "audit"

    def __init__(self, shard_count: int, socket_for, spawn_args=(),
                 snapshot_provider=None, ready_timeout: float = 180.0,
                 heartbeat_deadline_s: float = 10.0):
        super().__init__(range(shard_count), socket_for, spawn_args,
                         snapshot_provider=None,
                         ready_timeout=ready_timeout,
                         heartbeat_deadline_s=heartbeat_deadline_s)
        self.shard_count = int(shard_count)
        self._shard_snapshot = snapshot_provider  # (k) -> sync op
        self.generation: dict[int, int] = {k: 0 for k in self.engine_ids}

    def engine_label(self, k: int) -> str:
        return f"audit{k}"  # matches --engine-id in _spawn

    def _spawn(self, k: int) -> subprocess.Popen:
        cmd = [sys.executable, "-m", "gatekeeper_tpu_torch.control.engine",
               "--socket", self.socket_for(k),
               "--engine-id", f"audit{k}",
               "--device", str(k),
               "--serve", "auditslice",
               "--audit-shard-id", str(k),
               "--audit-shard-count",
               str(self.shard_count)] + self.spawn_args
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)

    def _resync(self, k: int) -> None:
        provider = self._shard_snapshot
        if provider is None:
            self._dirty[k] = False
            return
        with self._lock:
            self._dirty[k] = False
            try:
                op = provider(k)
                op["op"] = "sync"
                self._ctl[k].control(op, timeout=300.0)
                self._last_ok[k] = time.monotonic()
                self.generation[k] = self.generation.get(k, 0) + 1
                log.info("audit shard resynced",
                         details={"shard": k,
                                  "generation": self.generation[k]})
            except Exception as e:
                self._dirty[k] = True
                log.warning("audit shard resync failed; will retry",
                            details={"shard": k, "error": str(e)})

    def send(self, k: int, op: dict, timeout: float = 30.0) -> None:
        """Targeted single-shard library/data op (an owned object's
        add/remove goes ONLY to its owner; replicate() stays for
        broadcast ops). Failures mark the shard dirty for a monitor
        resync — same contract as replicate()."""
        with self._lock:
            ctl = self._ctl.get(k)
            if ctl is None or self._dirty.get(k):
                return
            try:
                ctl.control(op, timeout=timeout)
            except BackplaneError as e:
                self._dirty[k] = True
                log.warning("audit shard op failed; shard marked for "
                            "resync",
                            details={"shard": k, "error": str(e)})

    def _report_fleet(self) -> None:
        from . import metrics

        metrics.report_audit_shard_fleet(self.shard_count,
                                         self.alive_count())

    def sweep(self, k: int, body: bytes,
              timeout_s: float = 600.0) -> tuple[int, bytes]:
        """Run one slice sweep on shard k. Raises BackplaneError when
        the shard is down/unreachable — the caller owns the respawn-
        and-retry round trip (the orphaned-partition re-sweep)."""
        ctl = self._ctl.get(k)
        if ctl is None:
            raise BackplaneError(f"audit shard {k} not connected")
        return ctl.call("/v1/auditslice", body, timeout_s=timeout_s,
                        deadline=time.monotonic() + timeout_s)


# ------------------------------------------------------- frontend process


def frontend_main(argv=None) -> int:
    """Entry point of one pre-forked frontend process
    (`python -m gatekeeper_tpu_torch.control.backplane ...`): slim by design —
    no JAX, no client framework state, just HTTP + the backplane."""
    import argparse

    p = argparse.ArgumentParser(prog="gatekeeper-tpu-frontend")
    p.add_argument("--socket", required=True,
                   help="engine backplane socket(s); comma-separated "
                        "for the N-engine plane (the frontend routes "
                        "least-load with request-hash fallback)")
    p.add_argument("--port", type=int, default=8443)
    p.add_argument("--addr", default="")
    p.add_argument("--certfile", default="")
    p.add_argument("--keyfile", default="")
    p.add_argument("--worker-id", default="0")
    p.add_argument("--serve", default="admit,admitlabel,mutate")
    p.add_argument("--fail-closed", action="store_true")
    p.add_argument("--mutation-fail-closed", default="unset",
                   choices=["true", "false", "unset"],
                   help="mutation-webhook failure stance; 'unset' "
                        "inherits --fail-closed")
    p.add_argument("--default-timeout", type=float,
                   default=DEFAULT_WEBHOOK_TIMEOUT_S)
    p.add_argument("--trace-sample-rate", type=float, default=0.0,
                   help="fraction of requests traced at this edge "
                        "(stride-sampled; an inbound sampled "
                        "traceparent always traces)")
    p.add_argument("--shm-ring-mb", type=float, default=0.0,
                   help="shared-memory ring size (MB) for the zero-"
                        "copy backplane: review bytes ride a per-"
                        "frontend /dev/shm ring and the socket carries "
                        "descriptors only. 0 = inline payload frames")
    p.add_argument("--shm-ring-name", default="",
                   help="ring segment name prefix (the supervisor "
                        "passes a per-worker-slot name it can sweep "
                        "after a kill -9)")
    p.add_argument("--no-reuse-port", action="store_true")
    args = p.parse_args(argv)
    # the frontend is a sampling edge only — span context forwards to
    # the engine, which owns the recorder/metrics sinks
    gtrace.TRACER.configure(args.trace_sample_rate)
    sockets = [s for s in args.socket.split(",") if s]
    ring_prefix = args.shm_ring_name \
        or f"gk-bp-{os.getpid()}-{args.worker_id}"
    client = (BackplaneClient(sockets[0], worker_id=args.worker_id,
                              ring_mb=args.shm_ring_mb,
                              ring_prefix=ring_prefix)
              if len(sockets) == 1 else
              BackplaneRouter(sockets, worker_id=args.worker_id,
                              ring_mb=args.shm_ring_mb,
                              ring_prefix=ring_prefix))
    server = FrontendServer(
        client, port=args.port, addr=args.addr,
        certfile=args.certfile or None, keyfile=args.keyfile or None,
        reuse_port=not args.no_reuse_port,
        serve=tuple(s for s in args.serve.split(",") if s),
        fail_closed=args.fail_closed,
        mutation_fail_closed=(None if args.mutation_fail_closed == "unset"
                              else args.mutation_fail_closed == "true"),
        default_timeout=args.default_timeout,
        worker_id=args.worker_id)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    server.start()
    # long-lived-server GC tuning (mirrors the engine's Runtime.start):
    # everything built so far is permanent; freezing it out of the
    # collector's scan set keeps multi-hundred-ms gen-2 pauses out of
    # the admission tail (measured: max latency 1.2s -> ~25ms)
    import gc

    gc.collect()
    gc.freeze()
    # connect eagerly so the engine's connected-workers gauge reflects
    # the plane before the first request (reconnects are lazy per call)
    try:
        client.ensure_connected()
    except BackplaneError:
        pass  # engine not up yet; the first forward retries
    print(f"READY {server.port}", flush=True)

    def heartbeat():
        # 1/s liveness heartbeat on the supervisor pipe: the parent's
        # reader stamps each line, so a SIGSTOP'd/wedged frontend goes
        # silent and trips the heartbeat deadline. A closed pipe
        # (supervisor gone) ends the loop instead of crashing serving.
        while not stop.wait(1.0):
            try:
                print("HB", flush=True)
            except (OSError, ValueError):
                return

    threading.Thread(target=heartbeat, name="frontend-heartbeat",
                     daemon=True).start()
    stop.wait()
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(frontend_main())
