"""Shared-memory admission backplane: ring allocator semantics,
zero-copy descriptor frames, lifecycle under crashes, the inline
fallback under exhaustion, bulk/streaming ingest, and the vectored
`_send_frame`. The port's copy of tests/test_shm_ring.py.

Covers the acceptance contract directly:
  * zero per-review payload copies across the backplane on the happy
    path — asserted by spying on every frame's byte count (descriptor
    Q/'r' frames stay tens of bytes while the reviews are KBs);
  * cross-process zero-copy — a write-then-mutate canary proves the
    reader's memoryview IS the writer's mapping, not a copy;
  * inline-payload fallback under ring exhaustion, verdicts still
    correct;
  * frontend SIGKILL with descriptors in flight — the engine detaches
    and keeps serving, the supervisor sweeps the dead child's segments
    and the respawned frontend gets a fresh ring;
  * engine kill + reconnect re-handshakes the ring (descriptors only
    flow after a fresh A-frame ack).

Every test runs under a hard SIGALRM timeout (repo convention).
"""

from __future__ import annotations

import http.client
import json
import signal
import struct
import subprocess
import sys
import threading
import time

import pytest

from gatekeeper_tpu_torch.client import Backend, RegoDriver
from gatekeeper_tpu_torch.control import shm
from gatekeeper_tpu_torch.control.backplane import (
    BackplaneClient,
    BackplaneEngine,
    BackplaneError,
    FrontendServer,
    FrontendSupervisor,
    default_socket_path,
)
from gatekeeper_tpu_torch.control.webhook import (
    AdmissionDeadline,
    AdmissionShed,
    MicroBatcher,
    NamespaceLabelHandler,
    ValidationHandler,
)
from gatekeeper_tpu_torch.target import K8sValidationTarget

TARGET = "admission.k8s.gatekeeper.sh"
PER_TEST_TIMEOUT_S = 120

pytestmark = pytest.mark.skipif(not shm.supported(),
                                reason="no shared_memory support")


@pytest.fixture(autouse=True)
def _hard_timeout():
    def boom(signum, frame):  # pragma: no cover - only on a real hang
        raise TimeoutError(
            f"test exceeded the {PER_TEST_TIMEOUT_S}s hard timeout")

    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(PER_TEST_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


NEED_OWNER_TEMPLATE = {
    "apiVersion": "templates.gatekeeper.sh/v1beta1",
    "kind": "ConstraintTemplate",
    "metadata": {"name": "k8sneedowner"},
    "spec": {
        "crd": {"spec": {"names": {"kind": "K8sNeedOwner"}}},
        "targets": [{"target": TARGET, "rego": """
package k8sneedowner
violation[{"msg": "no owner label"}] {
  not input.review.object.metadata.labels.owner
}
"""}]},
}


def _policy_client():
    client = Backend(RegoDriver()).new_client([K8sValidationTarget()])
    client.add_template(NEED_OWNER_TEMPLATE)
    client.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "K8sNeedOwner", "metadata": {"name": "need-owner"},
        "spec": {}})
    return client


def _review(name, labels=None, uid=None, pad=0):
    obj = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": name, "namespace": "d"}}
    if labels:
        obj["metadata"]["labels"] = labels
    if pad:
        obj["metadata"]["annotations"] = {"pad": "x" * pad}
    return {"apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview",
            "request": {"uid": uid or f"uid-{name}",
                        "operation": "CREATE",
                        "kind": {"group": "", "version": "v1",
                                 "kind": "Pod"},
                        "name": name, "namespace": "d",
                        "userInfo": {"username": "ring"},
                        "object": obj}}


def _body(name, labels=None, uid=None, pad=0):
    return json.dumps(_review(name, labels, uid, pad)).encode()


# ------------------------------------------------------- ring allocator


def test_ring_append_release_wraparound_integrity():
    """Records allocate FIFO, release out of order, reclaim in FIFO
    order, and wrap at the end without ever straddling it — payload
    bytes survive bit-exact through many laps."""
    seg = shm.create("gk-test-ring-unit", 4096)
    try:
        w = shm.RingWriter(seg)
        r = shm.RingReader(seg)
        import random
        rng = random.Random(7)
        outstanding = []
        for i in range(400):
            data = bytes([i % 251]) * rng.randrange(1, 700)
            off = w.append(data)
            while off is None:
                # exhausted: release oldest records until FIFO space
                # frees up (one record may not be enough near a wrap
                # gap); an empty ring must never refuse
                assert outstanding, "empty ring refused an alloc"
                o_off, o_data = outstanding.pop(0)
                assert bytes(r.view(o_off, len(o_data))) == o_data
                r.release(o_off)
                off = w.append(data)
            outstanding.append((off, data))
            # release a random prefix sometimes (out-of-order consume
            # happens at the record level, reclaim stays FIFO)
            while outstanding and rng.random() < 0.4:
                o_off, o_data = outstanding.pop(0)
                assert bytes(r.view(o_off, len(o_data))) == o_data
                r.release(o_off)
        for o_off, o_data in outstanding:
            assert bytes(r.view(o_off, len(o_data))) == o_data
            r.release(o_off)
        assert w.used_fraction() == 0.0
        r.close()
        w.close()
    finally:
        shm.unlink("gk-test-ring-unit")


def test_ring_watermark_oversize_and_cancel():
    seg = shm.create("gk-test-ring-wm", 4096)
    try:
        w = shm.RingWriter(seg)
        # oversized single item refuses (max_item fraction of the ring)
        assert w.append(b"z" * 2000) is None
        assert w.fallbacks == 1
        # fill past the watermark: allocs succeed until headroom runs
        # out, then None without blocking
        offs = []
        while True:
            off = w.append(b"a" * 500)
            if off is None:
                break
            offs.append(off)
        assert offs, "nothing allocated before exhaustion"
        assert w.used_fraction() > 0.5
        # cancel frees the slots without a reader
        for off in offs:
            w.cancel(off)
        assert w.append(b"b" * 500) is not None
    finally:
        shm.unlink("gk-test-ring-wm")


def test_cross_process_zero_copy_canary():
    """The reader's memoryview IS the writer's mapping: a child
    process writes a canary into the segment, the parent slices a view
    once, then the child mutates one byte — the parent's EXISTING view
    reflects it. A copy anywhere between the processes fails this."""
    seg = shm.create("gk-test-ring-canary", 4096)
    try:
        child = subprocess.Popen(
            [sys.executable, "-c", """
import sys
from multiprocessing import shared_memory
seg = shared_memory.SharedMemory(name="gk-test-ring-canary")
seg.buf[100:108] = b"CANARY00"
print("READY", flush=True)
sys.stdin.readline()
seg.buf[100] = ord("X")
print("DONE", flush=True)
seg.close()
"""],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        try:
            assert child.stdout.readline().strip() == "READY"
            view = memoryview(seg.buf)[100:108]
            assert bytes(view) == b"CANARY00"
            child.stdin.write("\n")
            child.stdin.flush()
            assert child.stdout.readline().strip() == "DONE"
            # the SAME view object sees the child's byte: shared
            # mapping, no intermediate copy
            assert bytes(view) == b"XANARY00"
            view.release()
        finally:
            child.kill()
            child.wait(timeout=10)
    finally:
        shm.unlink("gk-test-ring-canary")


# ------------------------------------------- descriptor-only happy path


def _ring_plane(ring_mb=1.0, prefix="gk-test-plane", max_wait=0.001):
    client = _policy_client()
    validation = ValidationHandler(
        client, kube=None,
        batcher=MicroBatcher(client, max_wait=max_wait))
    sock = default_socket_path() + ".ring"
    engine = BackplaneEngine(sock, validation=validation,
                             ns_label=NamespaceLabelHandler(()))
    engine.start()
    bc = BackplaneClient(sock, worker_id="ringtest", ring_mb=ring_mb,
                         ring_prefix=prefix)
    return engine, bc, validation


def _await_ring_ack(bc, timeout=5.0):
    bc.ensure_connected()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if bc._ring_ok.is_set():
            return
        time.sleep(0.01)
    raise AssertionError("engine never acked the ring handshake")


def test_descriptor_only_frames_zero_payload_on_socket(monkeypatch):
    """THE acceptance assertion: on the happy path a multi-KB review
    crosses the backplane as a ~40-byte Q descriptor and its response
    as a ~20-byte 'r' descriptor — zero payload bytes on the socket in
    either direction."""
    import gatekeeper_tpu_torch.control.backplane as bp

    engine, bc, _ = _ring_plane()
    frames: list = []
    orig = bp._send_frame

    def spy(sock, lock, *parts):
        frames.append((bytes(parts[0][:1]),
                       4 + sum(len(p) for p in parts)))
        return orig(sock, lock, *parts)

    monkeypatch.setattr(bp, "_send_frame", spy)
    try:
        _await_ring_ack(bc)
        frames.clear()
        body = _body("big", pad=8000)
        assert len(body) > 8000
        status, out = bc.call("/v1/admit", body, 5.0,
                              time.monotonic() + 5)
        assert status == 200
        env = json.loads(bytes(out))
        assert env["response"]["allowed"] is False
        if hasattr(out, "release"):
            out.release()
        q_frames = [n for k, n in frames if k == b"Q"]
        r_frames = [n for k, n in frames if k == b"r"]
        assert q_frames and max(q_frames) < 256, \
            f"payload leaked onto the socket: Q frames {q_frames}"
        assert r_frames and max(r_frames) < 64, \
            f"response leaked onto the socket: r frames {r_frames}"
        # and the plain-R path carried no payload either
        assert not any(k == b"R" and n > 64 for k, n in frames)
    finally:
        bc.close()
        engine.stop(drain_timeout=1.0)


def test_ring_exhaustion_falls_back_inline_verdicts_correct():
    """When the ring has no space the accept path must NOT block: the
    review rides an inline frame and the verdict is identical."""
    engine, bc, _ = _ring_plane(ring_mb=0.01)  # 10 KB ring
    try:
        _await_ring_ack(bc)
        # occupy the ring directly (simulates a burst the engine has
        # not parsed yet), beyond the watermark
        held = []
        while True:
            off = bc._rings.req.append(b"x" * 600)
            if off is None:
                break
            held.append(off)
        fallbacks_before = bc._rings.req.fallbacks
        status, out = bc.call("/v1/admit", _body("noowner"), 5.0,
                              time.monotonic() + 5)
        assert status == 200
        assert json.loads(bytes(out))["response"]["allowed"] is False
        assert bc._rings.req.fallbacks > fallbacks_before
        # free the simulated backlog: the next call rides the ring
        for off in held:
            bc._rings.req.cancel(off)
        allocs_before = bc._rings.req.allocs
        status, out = bc.call("/v1/admit", _body("owned",
                                                 {"owner": "x"}),
                              5.0, time.monotonic() + 5)
        assert status == 200
        assert json.loads(bytes(out))["response"]["allowed"] is True
        assert bc._rings.req.allocs == allocs_before + 1
    finally:
        bc.close()
        engine.stop(drain_timeout=1.0)


def test_engine_kill_fails_inflight_and_ring_rehandshakes():
    """Chaos with the ring enabled: engine abort mid-flight fails the
    waiter (stance answer upstream), the ring un-acks, and a fresh
    engine re-attaches on reconnect — descriptors flow again."""
    engine, bc, validation = _ring_plane()
    sock = engine.socket_path
    try:
        _await_ring_ack(bc)
        stall = threading.Event()
        release = threading.Event()

        def evaluate(reviews):
            stall.set()
            release.wait(10)
            return [[] for _ in reviews]

        validation.batcher._evaluate = evaluate
        errs: list = []

        def call():
            try:
                bc.call("/v1/admit", _body("inflight"), 5.0,
                        time.monotonic() + 5)
            except BackplaneError as e:
                errs.append(e)

        t = threading.Thread(target=call)
        t.start()
        assert stall.wait(5), "request never reached the engine"
        engine.abort()
        t.join(timeout=10)
        release.set()
        assert errs, "in-flight descriptor did not fail on engine loss"
        assert not bc._ring_ok.is_set(), "ring stayed acked past drop"
        # outstanding request-ring slots were failed: ring is clean
        assert bc._rings.req.used_fraction() == 0.0
        # fresh engine on the same socket: reconnect re-handshakes
        client2 = _policy_client()
        engine2 = BackplaneEngine(
            sock, validation=ValidationHandler(
                client2, kube=None,
                batcher=MicroBatcher(client2, max_wait=0.001)),
            ns_label=NamespaceLabelHandler(()))
        engine2.start()
        try:
            deadline = time.monotonic() + 10
            status = None
            while time.monotonic() < deadline:
                try:
                    status, out = bc.call("/v1/admit",
                                          _body("after",
                                                {"owner": "x"}),
                                          5.0, time.monotonic() + 5)
                    break
                except BackplaneError:
                    time.sleep(0.1)
            assert status == 200
            _await_ring_ack(bc)
            allocs = bc._rings.req.allocs
            status, out = bc.call("/v1/admit", _body("ringy"),
                                  5.0, time.monotonic() + 5)
            assert status == 200
            assert bc._rings.req.allocs == allocs + 1, \
                "descriptor path did not resume after re-handshake"
        finally:
            engine2.stop(drain_timeout=1.0)
    finally:
        bc.close()
        engine.stop(drain_timeout=1.0)


# ---------------------------------------- supervisor lifecycle (SIGKILL)


def test_frontend_sigkill_fresh_ring_and_sweep():
    """kill -9 a frontend holding descriptors in flight: the engine
    detaches that ring and keeps serving, the supervisor sweeps the
    dead child's segments and the respawn gets a FRESH ring; shutdown
    leaves no /dev/shm leak."""
    client = _policy_client()
    validation = ValidationHandler(
        client, kube=None, batcher=MicroBatcher(client, max_wait=0.001))
    sock = default_socket_path() + ".sk"
    engine = BackplaneEngine(sock, validation=validation,
                             ns_label=NamespaceLabelHandler(()))
    engine.start()
    fronts = FrontendSupervisor(1, sock, port=0, addr="127.0.0.1",
                                ready_timeout=60.0, shm_ring_mb=1.0)
    import os
    ring_q = f"/dev/shm/{fronts._ring_prefix(0)}-q"

    def post(path, review, timeout=10):
        conn = http.client.HTTPConnection("127.0.0.1", fronts.port,
                                          timeout=timeout)
        try:
            conn.request("POST", path, json.dumps(review),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    try:
        fronts.start()
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and not os.path.exists(ring_q):
            time.sleep(0.05)
        assert os.path.exists(ring_q), "frontend never created its ring"
        status, out = post("/v1/admit", _review("warm", {"owner": "x"}))
        assert status == 200 and out["response"]["allowed"] is True

        # hold an evaluation so a descriptor is in flight at kill time
        stall = threading.Event()
        release = threading.Event()
        real_eval = validation.batcher._evaluate

        def evaluate(reviews):
            stall.set()
            release.wait(5)
            return real_eval(reviews)

        validation.batcher._evaluate = evaluate
        t = threading.Thread(
            target=lambda: _swallow(post, "/v1/admit",
                                    _review("mid-kill")))
        t.start()
        assert stall.wait(5), "in-flight request never reached engine"
        victim = fronts._procs[0]
        victim.kill()  # SIGKILL: no unlink, no drain
        victim.wait(timeout=10)
        release.set()
        validation.batcher._evaluate = real_eval
        t.join(timeout=10)

        # engine survived the dead frontend; supervisor respawns with a
        # freshly swept ring and the plane serves again
        deadline = time.monotonic() + 30
        ok = False
        while time.monotonic() < deadline:
            try:
                status, out = post("/v1/admit",
                                   _review("after-respawn"),
                                   timeout=5)
                if status == 200 \
                        and out["response"]["allowed"] is False:
                    ok = True
                    break
            except (OSError, http.client.HTTPException, ValueError):
                pass
            time.sleep(0.2)
        assert ok, "plane did not recover after frontend SIGKILL"
        assert engine.alive()
    finally:
        fronts.stop()
        engine.stop(drain_timeout=1.0)
    # the supervisor swept the segments on stop: no /dev/shm leak
    assert not os.path.exists(ring_q), "ring segment leaked"


def _swallow(fn, *args):
    try:
        fn(*args)
    except Exception:
        pass


# --------------------------------------------- bulk / streaming ingest


def test_submit_many_shed_and_deadline_semantics():
    stall = threading.Event()

    def evaluate(reviews):
        stall.wait(2.0)
        return [[] for _ in reviews]

    b = MicroBatcher(None, max_wait=0.001, evaluate=evaluate,
                     max_queue=2)
    try:
        outs = b.submit_many([{"r": i} for i in range(4)],
                             deadline=time.monotonic() + 0.3)
        # 2 entries queued (then expired against the stalled flusher),
        # 2 shed at enqueue by the bound
        sheds = [o for o in outs if isinstance(o, AdmissionShed)]
        deads = [o for o in outs if isinstance(o, AdmissionDeadline)]
        assert len(sheds) == 2 and len(deads) == 2
        stall.set()
        time.sleep(0.1)
        outs = b.submit_many([{"ok": 1}, {"ok": 2}],
                             deadline=time.monotonic() + 5)
        assert outs == [[], []]
    finally:
        stall.set()
        b.stop()


def test_handle_bulk_orders_verdicts_and_stances():
    client = _policy_client()
    validation = ValidationHandler(
        client, kube=None, batcher=MicroBatcher(client, max_wait=0.001))
    reviews = [
        _review("bad0"),
        _review("ok1", {"owner": "me"}),
        {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
         "request": {"uid": "sa", "userInfo": {
             "username": "system:serviceaccount:gatekeeper-system:"
                         "gatekeeper-admin"}}},
        _review("bad3"),
    ]
    outs = validation.handle_bulk(reviews, time.monotonic() + 10)
    assert [o["response"]["allowed"] for o in outs] == \
        [False, True, True, False]
    assert [o["response"]["uid"] for o in outs] == \
        ["uid-bad0", "uid-ok1", "sa", "uid-bad3"]
    assert "no owner label" in outs[0]["response"]["status"]["reason"]
    validation.batcher.stop()


def test_backplane_bulk_frame_roundtrip_and_not_ready():
    engine, bc, _ = _ring_plane()
    try:
        payloads = [_body(f"blk{i}",
                          {"owner": "x"} if i % 2 else None,
                          uid=f"blk-{i}")
                    for i in range(7)]
        outs = bc.review_bulk(payloads, timeout_s=10.0)
        assert len(outs) == 7
        envs = [json.loads(o) for o in outs]
        assert [e["response"]["allowed"] for e in envs] == \
            [False, True, False, True, False, True, False]
        assert [e["response"]["uid"] for e in envs] == \
            [f"blk-{i}" for i in range(7)]
        # a not-ready engine refuses bulk frames like Q frames
        engine.ready_check = lambda: False
        with pytest.raises(BackplaneError):
            bc.review_bulk(payloads[:1], timeout_s=5.0)
        engine.ready_check = None
    finally:
        bc.close()
        engine.stop(drain_timeout=1.0)


def test_backplane_bulk_over_iov_max_payloads():
    """A >500-review B frame exceeds sendmsg's IOV_MAX iovec cap in
    both directions (request parts AND the enveloped reply) —
    _send_frame must flatten, not surface EMSGSIZE as connection
    loss."""
    engine, bc, _ = _ring_plane()
    try:
        payloads = [_body(f"iov{i}", {"owner": "x"}, uid=f"iov-{i}")
                    for i in range(600)]
        outs = bc.review_bulk(payloads, timeout_s=30.0)
        assert len(outs) == 600
        assert all(json.loads(o)["response"]["allowed"] is True
                   for o in outs)
        assert json.loads(outs[599])["response"]["uid"] == "iov-599"
    finally:
        bc.close()
        engine.stop(drain_timeout=1.0)


def test_http_respond_ring_slice_on_tls_like_socket():
    """ssl.SSLSocket.sendmsg raises NotImplementedError (not
    AttributeError): the ring-slice response path must fall back to a
    plain concat send and still release the slot."""
    from gatekeeper_tpu_torch.control.webhook import FastHTTPServer

    seg = shm.create("gk-test-tls-resp", 4096)
    try:
        w = shm.RingWriter(seg)
        r = shm.RingReader(seg)
        off = w.append(b'{"ok":true}')
        payload = shm.RingSlice(r, off, 11)

        sent = []

        class TlsLikeConn:
            def sendmsg(self, bufs):
                raise NotImplementedError(
                    "sendmsg not allowed on instances of SSLSocket")

            def sendall(self, data):
                sent.append(bytes(data))

        FastHTTPServer._respond(TlsLikeConn(), 200, payload)
        body = b"".join(sent)
        assert body.endswith(b'{"ok":true}')
        assert b"Content-Length: 11" in body
        assert payload._released, "slot not released after TLS send"
        # released back to the allocator: the slot is reusable
        w2 = w.append(b"x" * 800)
        assert w2 is not None
        r.close()
        w.close()
    finally:
        shm.unlink("gk-test-tls-resp")


# ----------------------------------------------- _send_frame micro-bench


def test_send_frame_vectored_roundtrip_and_microbench():
    """The satellite fix: _send_frame must deliver multi-part frames
    byte-identically via sendmsg (no header+payload concat copy).
    Round-trips parts of every size class and micro-benches against
    the old concat implementation (informational print — CI boxes are
    too noisy to gate a ratio)."""
    import socket as socket_mod

    from gatekeeper_tpu_torch.control.backplane import (
        _recv_exact,
        _send_frame,
    )

    a, b = socket_mod.socketpair()
    lock = threading.Lock()
    try:
        cases = [
            (b"Q", b"x" * 3, b"", b"tail"),
            (b"R", b"y" * 70000),            # > default socket buffer
            (memoryview(b"Z" * 1000),),
            (b"S",),
        ]
        got = []

        def reader():
            for _ in cases:
                (n,) = struct.unpack("!I", _recv_exact(b, 4))
                got.append(_recv_exact(b, n))

        t = threading.Thread(target=reader)
        t.start()
        for parts in cases:
            _send_frame(a, lock, *parts)
        t.join(timeout=10)
        assert got == [b"".join(bytes(p) for p in parts)
                       for parts in cases]

        # micro-bench: new vectored send vs the old concat send
        payload = b"p" * 4096
        n_iter = 2000

        def drain(total):
            left = total
            while left > 0:
                left -= len(b.recv(65536))

        d = threading.Thread(target=drain,
                             args=(n_iter * (4 + 1 + len(payload)),))
        d.start()
        t0 = time.perf_counter()
        for _ in range(n_iter):
            _send_frame(a, lock, b"Q", payload)
        t_new = time.perf_counter() - t0
        d.join(timeout=30)

        def old_send(sock, lck, *parts):
            pl = b"".join(parts)
            msg = struct.pack("!I", len(pl)) + pl
            with lck:
                sock.sendall(msg)

        d = threading.Thread(target=drain,
                             args=(n_iter * (4 + 1 + len(payload)),))
        d.start()
        t0 = time.perf_counter()
        for _ in range(n_iter):
            old_send(a, lock, b"Q", payload)
        t_old = time.perf_counter() - t0
        d.join(timeout=30)
        print(f"\n_send_frame 4KB x{n_iter}: vectored "
              f"{t_new * 1e6 / n_iter:.1f}us vs concat "
              f"{t_old * 1e6 / n_iter:.1f}us per frame")
    finally:
        a.close()
        b.close()


# ------------------------------------- the port against the JAX package

def _ring_bytes(client_pkg: str, engine_pkg: str) -> list:
    """One package's BackplaneClient (a 1 MB ring) against one
    package's BackplaneEngine over the need-owner library: the raw
    bytes of a bulk frame's verdicts and of single Q frames (ring
    descriptors), in order."""
    from importlib import import_module

    def pkg(name):
        return "gatekeeper_tpu_torch" if name == "torch" else \
            "gatekeeper_tpu"

    ebp = import_module(f"{pkg(engine_pkg)}.control.backplane")
    ewh = import_module(f"{pkg(engine_pkg)}.control.webhook")
    ecl = import_module(f"{pkg(engine_pkg)}.client")
    etg = import_module(f"{pkg(engine_pkg)}.target")
    cbp = import_module(f"{pkg(client_pkg)}.control.backplane")
    client = ecl.Backend(ecl.RegoDriver()).new_client(
        [etg.K8sValidationTarget()])
    client.add_template(NEED_OWNER_TEMPLATE)
    client.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "K8sNeedOwner", "metadata": {"name": "need-owner"},
        "spec": {}})
    validation = ewh.ValidationHandler(
        client, kube=None, batcher=ewh.MicroBatcher(client,
                                                    max_wait=0.001))
    sock = ebp.default_socket_path() + f".x-{client_pkg}-{engine_pkg}"
    engine = ebp.BackplaneEngine(sock, validation=validation,
                                 ns_label=ewh.NamespaceLabelHandler(()))
    engine.start()
    bc = cbp.BackplaneClient(sock, worker_id="x", ring_mb=1.0,
                             ring_prefix=f"gk-x-{client_pkg}{engine_pkg}")
    try:
        _await_ring_ack(bc)
        payloads = [_body(f"x{i}", {"owner": "x"} if i % 3 else None,
                          uid=f"x-{i}", pad=512 * i) for i in range(6)]
        out = [bytes(b) for b in bc.review_bulk(payloads, timeout_s=10.0)]
        for p in payloads:
            status, body = bc.call("/v1/admit", p, timeout_s=10.0,
                                   deadline=time.monotonic() + 10.0)
            out.append((status, bytes(body)))
    finally:
        bc.close()
        engine.stop(drain_timeout=1.0)
        validation.batcher.stop()
    return out


def test_ring_verdict_bytes_equal_the_jax_package():
    """The ring protocol is the JAX package's: the port's client and
    engine give the JAX package's verdict bytes, bulk and single, and
    the port's client speaks to the JAX package's engine unchanged."""
    got = _ring_bytes("torch", "torch")
    want = _ring_bytes("jax", "jax")
    assert got == want
    assert _ring_bytes("torch", "jax") == want
    assert [json.loads(b)["response"]["allowed"] for b in got[:6]] == \
        [False, True, True, False, True, True]
