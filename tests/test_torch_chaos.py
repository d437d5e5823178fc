"""Chaos orchestrator, gray-failure liveness, crash consistency. The
port's copy of tests/test_chaos.py (its Runtimes and shard children on
--device cpu).

Covers:
  * backplane frame hygiene: a truncated frame and a corrupted
    (oversized-length) header each drop ONLY that connection — clean
    close, re-handshake, the engine keeps serving;
  * wire-fault injection modes (reset / truncate / slow) through the
    `backplane.wire` point;
  * schedule determinism: one integer seed fully determines the fault
    schedule (kinds, targets, offsets, params);
  * gray-failure liveness: a SIGSTOP'd engine child mid-burst is
    detected by the poll-age heartbeat, SIGKILLed, respawned, and the
    plane answers every request meanwhile (failover, zero unanswered);
    a SIGSTOP'd audit shard mid-sweep heals the same way and the
    re-swept round stays bit-equal;
  * crash-loop backoff: jittered exponential delays, first-death-free,
    healthy-uptime reset, breaker trip, gauge teardown on close;
  * the crash-consistency verifier's own checks (stance contract,
    fencing, stale gauges) and the /debug/chaos ledger provider;
  * utils/faults armed()/fired snapshots.
"""

from __future__ import annotations

import http.client
import json
import signal
import socket
import struct
import threading
import time

import pytest

from gatekeeper_tpu_torch.client import Backend, RegoDriver
from gatekeeper_tpu_torch.control import chaos
from gatekeeper_tpu_torch.control import metrics as gm
from gatekeeper_tpu_torch.control.backplane import (
    MAX_FRAME_LEN,
    BackplaneClient,
    BackplaneEngine,
    BackplaneError,
)
from gatekeeper_tpu_torch.control.liveness import Backoff
from gatekeeper_tpu_torch.control.webhook import MicroBatcher, ValidationHandler
from gatekeeper_tpu_torch.target import K8sValidationTarget
from gatekeeper_tpu_torch.utils.faults import FAULTS

PER_TEST_TIMEOUT_S = 180


@pytest.fixture(autouse=True)
def _hard_timeout_and_clean_faults():
    def boom(signum, frame):  # pragma: no cover - only on a real hang
        raise TimeoutError(
            f"test exceeded the {PER_TEST_TIMEOUT_S}s hard timeout")

    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(PER_TEST_TIMEOUT_S)
    FAULTS.reset()
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        FAULTS.reset()


def _review(uid: str) -> bytes:
    return json.dumps({
        "apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
        "request": {
            "uid": uid, "operation": "CREATE",
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "object": {"apiVersion": "v1", "kind": "Pod",
                       "metadata": {"name": f"p-{uid}",
                                    "namespace": "default",
                                    "labels": {"owner": "t"}}}},
    }).encode()


def _engine(tmp_path, name="e"):
    client = Backend(RegoDriver()).new_client([K8sValidationTarget()])
    validation = ValidationHandler(
        client, kube=None, batcher=MicroBatcher(client, max_wait=0.001))
    sock = str(tmp_path / f"{name}.sock")
    eng = BackplaneEngine(sock, validation=validation)
    eng.start()
    return eng, sock


def _admit(client, uid, timeout=5.0):
    return client.call("/v1/admit", _review(uid), timeout,
                       time.monotonic() + timeout)


# --------------------------------------------------------- frame hygiene


def test_truncated_frame_drops_connection_then_rehandshakes(tmp_path):
    eng, sock = _engine(tmp_path)
    try:
        client = BackplaneClient(sock, worker_id="t1")
        status, body = _admit(client, "a")
        assert status == 200
        # next Q frame is cut mid-payload and the socket closed: the
        # engine must treat it as a dead peer (no partial parse), and
        # the CLIENT must re-handshake on the next call
        FAULTS.inject("backplane.wire", mode="truncate", count=1)
        with pytest.raises(BackplaneError):
            _admit(client, "b")
        status, body = _admit(client, "c")
        assert status == 200
        assert json.loads(bytes(body))["response"]["uid"] == "c"
        client.close()
    finally:
        eng.stop(drain_timeout=1.0)


def test_corrupt_oversized_header_closes_only_that_connection(tmp_path):
    eng, sock = _engine(tmp_path)
    try:
        healthy = BackplaneClient(sock, worker_id="ok")
        assert _admit(healthy, "h1")[0] == 200
        # raw connection speaking garbage: a length claiming 2 GiB
        raw = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        raw.connect(sock)
        raw.sendall(struct.pack(">I", 0x7FFFFFFF) + b"junk")
        # the engine must close THIS connection (bounded read, no 2 GiB
        # allocation), visible as EOF or RST on the raw socket...
        raw.settimeout(5)
        try:
            assert raw.recv(1) == b""
        except ConnectionResetError:
            pass  # closing with unread bytes queued sends RST; same verdict
        raw.close()
        # ...while the healthy client keeps its session
        assert _admit(healthy, "h2")[0] == 200
        healthy.close()
    finally:
        eng.stop(drain_timeout=1.0)


def test_wire_fault_modes(tmp_path):
    eng, sock = _engine(tmp_path)
    try:
        client = BackplaneClient(sock, worker_id="w")
        # reset: hard RST mid-frame; the call fails, the next one
        # reconnects
        FAULTS.inject("backplane.wire", mode="reset", count=1)
        with pytest.raises(BackplaneError):
            _admit(client, "r")
        assert _admit(client, "r2")[0] == 200
        # slow: the frame drips but COMPLETES — no error, just latency
        FAULTS.inject("backplane.wire", mode="slow", param="0.001",
                      count=1)
        status, body = _admit(client, "s", timeout=10)
        assert status == 200
        assert json.loads(bytes(body))["response"]["uid"] == "s"
        client.close()
    finally:
        eng.stop(drain_timeout=1.0)
    assert MAX_FRAME_LEN >= 64 * 1024 * 1024  # rings fit under the cap


# -------------------------------------------------- schedule determinism


def test_schedule_deterministic_from_seed():
    a = chaos.ChaosSchedule.generate(1234, n_actions=16, horizon_s=30)
    b = chaos.ChaosSchedule.generate(1234, n_actions=16, horizon_s=30)
    assert a.to_dict() == b.to_dict(), \
        "one seed must yield one schedule, bit for bit"
    c = chaos.ChaosSchedule.generate(1235, n_actions=16, horizon_s=30)
    assert a.to_dict() != c.to_dict()
    # offsets sorted, targets bounded, kinds drawn from the surface
    ts = [act.t for act in a.actions]
    assert ts == sorted(ts)
    assert all(0 <= act.target < 4 for act in a.actions)
    assert all(act.kind in chaos.SURFACE for act in a.actions)


def test_orchestrator_records_skips_on_partial_plane():
    sched = chaos.ChaosSchedule(
        0, [chaos.FaultAction(t=0.0, kind="engine.kill"),
            chaos.FaultAction(t=0.0, kind="backplane.error")])
    orch = chaos.ChaosOrchestrator(chaos.PlaneHandles(), sched)
    ledger = orch.run()
    assert ledger[0]["detail"] == {"skipped": "no live engine child"}
    assert ledger[1]["detail"]["armed"] == "backplane.engine:error"
    assert FAULTS.armed_snapshot()  # the armed fault is visible...
    snap = chaos.debug_snapshot()
    assert snap["seed"] == 0 and len(snap["ledger"]) == 2
    FAULTS.reset()


# ------------------------------------------------------ crash-loop backoff


def _breaker_value(supervisor: str) -> float:
    series = gm.gauge_series("gatekeeper_tpu_crashloop_breaker")
    return series.get((supervisor,), 0.0)


def test_backoff_exponential_jittered_and_capped():
    b = Backoff("frontend", base=0.25, factor=2.0, cap=4.0,
                healthy_after=30.0, trip_after=5)
    delays = [b.delay_for(0, uptime_s=0.1) for _ in range(7)]
    assert delays[0] == 0.0, "first death respawns immediately"
    for i, lo_mult in enumerate([1, 2, 4, 8], start=1):
        lo = min(4.0, 0.25 * lo_mult) * 0.5
        hi = min(4.0, 0.25 * lo_mult * 1.5)
        assert lo <= delays[i] <= hi, (i, delays)
    assert delays[6] <= 4.0, "cap must bound the backoff"
    assert b.pending(0)
    assert _breaker_value("frontend") == 1.0, \
        "5 fast deaths must trip the breaker"
    # healthy uptime resets the slot: breaker clears, next death free
    b.note_healthy(0)
    assert _breaker_value("frontend") == 0.0
    assert b.delay_for(0, uptime_s=31.0) == 0.0
    b.close()
    assert all(v == 0.0 for v in gm.gauge_series(
        "gatekeeper_tpu_respawn_backoff_seconds").values())
    assert all(v == 0.0 for v in gm.gauge_series(
        "gatekeeper_tpu_crashloop_breaker").values())


def test_backoff_long_uptime_resets_count():
    b = Backoff("engine", base=0.25, healthy_after=10.0)
    assert b.delay_for(1, uptime_s=0.0) == 0.0
    assert b.delay_for(1, uptime_s=0.0) > 0.0
    # a child that ran healthy past the threshold starts over
    assert b.delay_for(1, uptime_s=11.0) == 0.0
    b.close()


# ------------------------------------------------- gray failure: engine


def test_sigstop_engine_mid_burst_fails_over_and_recovers():
    """SIGSTOP (not SIGKILL) an engine child mid-burst: the process is
    alive but silent — only the poll-age heartbeat can see it. The
    frontends must fail over (every request still answered), and the
    supervisor must SIGKILL + respawn the wedged child without operator
    action, recording a wedge recovery."""
    from gatekeeper_tpu_torch.control.main import Runtime, build_parser

    args = build_parser().parse_args([
        "--device", "cpu",
        "--fake-kube", "--port", "0", "--prometheus-port", "0",
        "--disable-cert-rotation", "--health-addr", ":0",
        "--operation", "webhook", "--admission-workers", "2",
        "--admission-engines", "2"])
    rt = Runtime(args)
    rt.args.metrics_backend = "none"
    rt.start()
    try:
        rt.engines.heartbeat_deadline_s = 3.0
        deadline = time.monotonic() + 30
        while rt.backplane.connected < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        victim = rt.engines._procs[1]
        assert victim is not None

        answered, errors = {}, []

        def burst(k):
            conn = http.client.HTTPConnection(
                "127.0.0.1", rt.frontends.port, timeout=15)
            for i in range(20):
                uid = f"b{k}-{i}"
                try:
                    conn.request("POST", "/v1/admit?timeout=8s",
                                 _review(uid),
                                 {"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    body = json.loads(resp.read())
                    answered[uid] = (resp.status, body)
                except Exception as e:  # pragma: no cover - fail below
                    errors.append((uid, repr(e)))
                    conn.close()
                    conn = http.client.HTTPConnection(
                        "127.0.0.1", rt.frontends.port, timeout=15)
                time.sleep(0.02)
            conn.close()

        threads = [threading.Thread(target=burst, args=(k,),
                                    daemon=True) for k in range(2)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        rt.engines.pause_engine(1)  # gray failure, mid-burst
        for t in threads:
            t.join(60)

        assert not errors, errors
        assert len(answered) == 40, "zero unanswered during failover"
        for uid, (status, body) in answered.items():
            assert status == 200
            assert body["response"]["uid"] == uid
            assert body["response"]["allowed"] is True

        # detected by the heartbeat deadline, killed, respawned
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            cur = rt.engines._procs.get(1)
            if cur is not None and cur is not victim \
                    and rt.engines.alive_count() == 1:
                break
            time.sleep(0.2)
        assert rt.engines._procs[1] is not victim, \
            "wedged engine must be killed and respawned"
        assert victim.poll() is not None, "the paused child must be dead"
        text = gm.REGISTRY.render()
        assert 'gatekeeper_tpu_fault_recovery_seconds_count' \
               '{component="engine",fault="wedge"}' in text
    finally:
        rt.stop()


# -------------------------------------------- gray failure: audit shard


def test_sigstop_audit_shard_mid_sweep_converges_bit_equal(tmp_path):
    """SIGSTOP shard 1 while its slice sweep is in flight: the sweep
    Q-frame stalls, the heartbeat trips, the supervisor SIGKILLs and
    respawns the shard, the resync rebuilds only ITS slice (generation
    bump on the victim only), the leader re-dispatches the orphaned
    partition — and the composed round is still bit-equal."""
    from tools.chaos_verify import (_cluster_kube, _cluster_objects,
                                    _library, _result_key)
    from gatekeeper_tpu_torch.client import Backend
    from gatekeeper_tpu_torch.control.audit import (AuditManager,
                                              ShardedAuditPlane)
    from gatekeeper_tpu_torch.control.backplane import AuditShardSupervisor
    from gatekeeper_tpu_torch.ir import TorchDriver
    from gatekeeper_tpu_torch.target import K8sValidationTarget

    objs = _cluster_objects()
    okube = _cluster_kube(objs)
    oracle_client = Backend(TorchDriver(device="cpu")).new_client(
        [K8sValidationTarget()])
    _library(oracle_client)
    oracle = AuditManager(okube, oracle_client, interval=3600,
                          incremental=True)
    oracle_results = [_result_key(r) for r in oracle.audit_once()]
    assert oracle_results

    kube = _cluster_kube(objs)
    leader = Backend(TorchDriver(device="cpu")).new_client([K8sValidationTarget()])
    sock = str(tmp_path / "audit.sock")
    plane_box = []
    sup = AuditShardSupervisor(
        2, socket_for=lambda k: f"{sock}.{k}",
        spawn_args=["--log-level", "WARNING", "--device", "cpu"],
        snapshot_provider=lambda k: plane_box[0].sync_snapshot(k),
        heartbeat_deadline_s=3.0)
    plane = ShardedAuditPlane(kube, leader, sup, 2)
    plane_box.append(plane)
    plane.attach()
    _library(leader)
    mgr = AuditManager(kube, leader, interval=3600, shard_plane=plane)
    sup.start()
    try:
        assert [_result_key(r) for r in mgr.audit_once()] == \
            oracle_results
        gen_before = dict(sup.generation)

        pauser = threading.Timer(0.05, lambda: sup.pause_engine(1))
        pauser.start()
        round2 = [_result_key(r) for r in mgr.audit_once()]
        pauser.join()
        assert round2 == oracle_results, \
            "mid-sweep SIGSTOP round must converge bit-equal"
        # the wedge respawn is asynchronous: the leader re-sweeps the
        # orphaned slice without waiting for the supervisor, so the
        # generation bump may land after the round has already converged
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            if sup.generation[1] > gen_before[1] and sup.alive_count() == 2:
                break
            time.sleep(0.2)
        # only the victim's slice was rebuilt and re-swept
        assert sup.generation[1] > gen_before[1], \
            "the wedged shard must have been respawned + resynced"
        assert sup.generation[0] == gen_before[0], \
            "the healthy shard must NOT have been resynced"
        assert sup.alive_count() == 2
        text = gm.REGISTRY.render()
        assert 'gatekeeper_tpu_fault_recovery_seconds_count' \
               '{component="audit_shard",fault="wedge"}' in text
    finally:
        sup.stop()
        plane.stop()


# ----------------------------------------------------------- verifier


def test_verifier_stance_contract():
    v = chaos.Verifier()
    ok = {"u1": (200, {"response": {"uid": "u1", "allowed": True}}),
          # fail-open stance answer: allowed, engine unreachable
          "u2": (200, {"response": {"uid": "u2", "allowed": True,
                                    "status": {"code": 503}}})}
    assert v.check_admissions(2, ok, [], fail_closed=False).ok
    bad = {
        # stance answer contradicting fail_closed=False
        "u3": (200, {"response": {"uid": "u3", "allowed": False,
                                  "status": {"code": 503}}}),
        # internal NOT_READY leaked to HTTP
        "u4": (200, {"response": {"uid": "u4", "allowed": True,
                                  "status": {"code": 599}}}),
        # envelope uid mismatch
        "u5": (200, {"response": {"uid": "other", "allowed": True}}),
    }
    r = v.check_admissions(4, bad, [("u6", "conn reset")],
                           fail_closed=False)
    assert len(r.violations) == 4  # 3 contract breaks + 1 unanswered


def test_verifier_fencing_and_stale_gauges():
    v = chaos.Verifier()
    writes = [(1.0, "a", "a"), (2.0, "a", "thief"), (3.0, "b", "a")]
    r = v.check_fencing(writes, writers={"a", "b"})
    # the thief window is recorded but only the cross-candidate write
    # violates
    assert r.detail["holder_mismatches"] == 2
    assert len(r.violations) == 1 and "'b'" in r.violations[0]
    # stale-gauge check: a non-zero lifecycle series must be caught
    gm.report_respawn_backoff("frontend", 1.25)
    r2 = v.check_stale_gauges()
    assert any("respawn_backoff" in s for s in r2.violations)
    gm.report_respawn_backoff("frontend", 0.0)
    v2 = chaos.Verifier()
    assert v2.check_stale_gauges().ok
    # the family list is shared with gklint's static checker at runtime
    names = chaos.lifecycle_gauge_names()
    assert "gatekeeper_tpu_respawn_backoff_seconds" in names
    assert "gatekeeper_tpu_crashloop_breaker" in names


def test_faults_armed_and_fired_snapshots():
    FAULTS.reset()
    assert FAULTS.armed_snapshot() == {}
    FAULTS.inject("backplane.engine", mode="error", count=2)
    FAULTS.inject("kube.write", mode="error", param="503", rate=0.5)
    snap = FAULTS.armed_snapshot()
    assert snap["backplane.engine"]["mode"] == "error"
    assert snap["backplane.engine"]["count"] == 2
    assert snap["kube.write"]["param"] == "503"
    assert snap["kube.write"]["rate"] == 0.5
    assert FAULTS.consume("backplane.engine") is not None
    assert FAULTS.fired_snapshot() == {"backplane.engine": 1}
    FAULTS.reset()
    assert FAULTS.armed_snapshot() == {} and FAULTS.fired_snapshot() == {}


def test_debug_chaos_provider_wired():
    from gatekeeper_tpu_torch.control.main import Runtime, build_parser

    args = build_parser().parse_args([
        "--device", "cpu",
        "--fake-kube", "--port", "0", "--prometheus-port", "0",
        "--disable-cert-rotation", "--health-addr", ":0",
        "--operation", "webhook"])
    rt = Runtime(args)  # not started: providers are wired at build time
    providers = rt.debug_providers()
    snap = providers["chaos"]("")
    assert set(snap) == {"seed", "schedule", "ledger", "faults"}
    assert set(snap["faults"]) == {"armed", "fired"}


# ------------------------------------- the port against the JAX package

def _chaos_transcript(chaos_mod) -> list:
    """One package's chaos schedule from three seeds and its verifier's
    verdicts on the stance contract's answers."""
    out = [chaos_mod.ChaosSchedule.generate(seed, n_actions=16,
                                            horizon_s=30).to_dict()
           for seed in (1234, 1235, 7)]
    v = chaos_mod.Verifier()
    answers = {
        "u1": (200, {"response": {"uid": "u1", "allowed": True}}),
        "u2": (200, {"response": {"uid": "u2", "allowed": True,
                                  "status": {"code": 503}}}),
        "u3": (200, {"response": {"uid": "u3", "allowed": False,
                                  "status": {"code": 503}}}),
        "u4": (200, {"response": {"uid": "u4", "allowed": True,
                                  "status": {"code": 599}}}),
        "u5": (200, {"response": {"uid": "other", "allowed": True}})}
    for fail_closed in (False, True):
        r = v.check_admissions(6, answers, [("u6", "conn reset")],
                               fail_closed=fail_closed)
        out.append([r.ok, sorted(r.violations)])
    r = v.check_fencing([(1.0, "a", "a"), (2.0, "a", "thief"),
                         (3.0, "b", "a")], writers={"a", "b"})
    out.append([r.ok, r.violations, r.detail])
    return out


def test_schedule_and_verifier_equal_the_jax_package():
    """The chaos orchestrator's seeded schedule and the verifier's
    contract checks (control/chaos.py, a verbatim copy) give the JAX
    package's results."""
    from gatekeeper_tpu.control import chaos as jchaos

    assert _chaos_transcript(chaos) == _chaos_transcript(jchaos)
