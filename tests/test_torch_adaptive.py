"""Adaptive serving controller + degradation ladder: the port's copy of
tests/test_adaptive.py, and its controller's transcript against the JAX
package's on the same signals (the last case).

Drives AdaptiveController.tick() deterministically — a private Registry
seeded with exactly the signal series the controller samples, fake
batcher/engines/SLO actuators, explicit `now` values — and asserts the
control policies, the anti-oscillation rate limits (per-knob cooldown,
reversal hysteresis, flip accounting), the degradation-ladder
escalation/de-escalation state machine, the ValidationHandler rung
gates on a real serving pipeline, the EngineSupervisor fan-out clamp,
and the kill switch's bit-exact baseline restore."""

from __future__ import annotations

import threading
import time

import pytest

from gatekeeper_tpu_torch.client import Backend, RegoDriver
from gatekeeper_tpu_torch.control import metrics
from gatekeeper_tpu_torch.control.adaptive import (
    RUNG_CACHE_ONLY,
    RUNG_FAIL_STANCE,
    RUNG_NORMAL,
    RUNG_TIGHTEN_SHED,
    AdaptiveController,
    DegradationLadder,
)
from gatekeeper_tpu_torch.control.backplane import EngineSupervisor
from gatekeeper_tpu_torch.control.metrics import FILL_BUCKETS, Registry
from gatekeeper_tpu_torch.control.webhook import (
    SERVICE_ACCOUNT,
    MicroBatcher,
    ValidationHandler,
)
from gatekeeper_tpu_torch.target import K8sValidationTarget

TARGET = "admission.k8s.gatekeeper.sh"


# ------------------------------------------------------------ fakes


class FakeBatcher:
    """MicroBatcher's knob surface without its threads."""

    def __init__(self, max_wait=0.005, max_batch=256, max_queue=64):
        self.max_wait = max_wait
        self.max_batch = max_batch
        self.max_queue = max_queue

    def set_knobs(self, max_wait=None, max_batch=None, max_queue=None):
        if max_wait is not None:
            self.max_wait = max(0.0, float(max_wait))
        if max_batch is not None:
            self.max_batch = max(1, int(max_batch))
        if max_queue is not None:
            self.max_queue = max(0, int(max_queue))
        return self.knob_values()

    def knob_values(self):
        return {"max_wait": self.max_wait, "max_batch": self.max_batch,
                "max_queue": self.max_queue}


class FakeEngines:
    """EngineSupervisor's fan-out surface."""

    def __init__(self, ids=("1", "2", "3")):
        self.engine_ids = list(ids)
        self._total = 1 + len(ids)
        self.calls: list = []

    def active_total(self):
        return self._total

    def scale_to(self, total):
        total = max(1, min(1 + len(self.engine_ids), int(total)))
        self._total = total
        self.calls.append(total)
        return total


class FakeSlo:
    def __init__(self):
        self.rates: dict = {}

    def set_burn(self, b5m, b1h):
        self.rates = {"availability": {"5m": {"burn_rate": b5m},
                                       "1h": {"burn_rate": b1h}}}

    def latest(self):
        return self.rates


def _seed_seals(reg, reason, n, fill):
    for _ in range(n):
        reg.counter_add("gatekeeper_tpu_batch_seal_total", "h",
                        reason=reason, plane="admission")
        reg.observe("gatekeeper_tpu_batch_fill_ratio", "h", fill,
                    buckets=FILL_BUCKETS, plane="admission")


def _controller(reg, **kw):
    kw.setdefault("interval", 999.0)      # the thread never ticks on
    kw.setdefault("cooldown_s", 0.0)      # its own: tests drive tick()
    kw.setdefault("hysteresis_s", 0.0)
    c = AdaptiveController(registry=reg, **kw)
    return c


# -------------------------------------------------- batch-shape policy


def test_max_wait_trickle_shrinks_wait():
    reg = Registry()
    b = FakeBatcher(max_wait=0.008)
    c = _controller(reg, batcher=b)
    c.arm()
    try:
        _seed_seals(reg, "max_wait", 10, fill=0.01)
        c.tick(now=100.0)
        assert b.max_wait == pytest.approx(0.004)
        acts = c.actuations()
        assert acts and acts[-1]["knob"] == "batch_max_wait"
        assert acts[-1]["direction"] == "down"
    finally:
        c.disarm()


def test_full_seals_grow_batch():
    reg = Registry()
    b = FakeBatcher(max_batch=128)
    c = _controller(reg, batcher=b)
    c.arm()
    try:
        _seed_seals(reg, "full", 10, fill=1.0)
        c.tick(now=100.0)
        assert b.max_batch == 256
        assert c.actuations()[-1]["knob"] == "batch_max_batch"
        assert c.actuations()[-1]["direction"] == "up"
    finally:
        c.disarm()


def test_quiet_plane_relaxes_toward_baseline_exactly():
    reg = Registry()
    b = FakeBatcher(max_wait=0.008)
    c = _controller(reg, batcher=b, relax_after_s=5.0)
    c.arm()
    try:
        _seed_seals(reg, "max_wait", 10, fill=0.01)
        c.tick(now=100.0)
        assert b.max_wait < 0.008
        # quiet window elapses: the knob drifts back and LANDS on the
        # baseline (min/max against the baseline, not an approach that
        # overshoots or stalls one step short)
        for i in range(10):
            c.tick(now=120.0 + i)
        assert b.max_wait == 0.008
    finally:
        c.disarm()


def test_clamp_to_declared_bounds():
    reg = Registry()
    b = FakeBatcher(max_wait=0.001)
    c = _controller(reg, batcher=b, max_wait_lo=0.0008)
    c.arm()
    try:
        _seed_seals(reg, "max_wait", 10, fill=0.01)
        c.tick(now=100.0)
        assert b.max_wait == 0.0008      # halving clamped at lo
        assert c.actuations()[-1]["clamped"] is True
    finally:
        c.disarm()


# --------------------------------------------- cooldown / hysteresis


def test_cooldown_suppresses_same_direction_repeat():
    reg = Registry()
    b = FakeBatcher(max_wait=0.02)
    c = _controller(reg, batcher=b, cooldown_s=5.0)
    c.arm()
    try:
        _seed_seals(reg, "max_wait", 10, fill=0.01)
        c.tick(now=100.0)
        assert b.max_wait == pytest.approx(0.01)
        _seed_seals(reg, "max_wait", 10, fill=0.01)
        c.tick(now=101.0)                # inside the 5s cooldown
        assert b.max_wait == pytest.approx(0.01)
        assert c.knobs["batch_max_wait"].suppressed >= 1
        _seed_seals(reg, "max_wait", 10, fill=0.01)
        c.tick(now=106.0)                # cooldown elapsed
        assert b.max_wait == pytest.approx(0.005)
    finally:
        c.disarm()


def test_hysteresis_holds_direction_reversals_and_counts_flips():
    reg = Registry()
    b = FakeBatcher(max_wait=0.008)
    c = _controller(reg, batcher=b, hysteresis_s=10.0,
                    relax_after_s=2.0)
    c.arm()
    try:
        _seed_seals(reg, "max_wait", 10, fill=0.01)
        c.tick(now=100.0)                # down
        assert b.max_wait == pytest.approx(0.004)
        # quiet: the relax step is a REVERSAL (up) — hysteresis holds
        # it inside the window even though the cooldown would allow it
        c.tick(now=105.0)
        assert b.max_wait == pytest.approx(0.004)
        assert c.knobs["batch_max_wait"].suppressed >= 1
        assert c.flip_count() == 0
        c.tick(now=111.0)                # window elapsed: flip lands
        assert b.max_wait == pytest.approx(0.008)
        assert c.flip_count() == 1
    finally:
        c.disarm()


# -------------------------------------------------- degradation ladder


def test_ladder_escalates_one_rung_per_dwell_after_shed_floor():
    reg = Registry()
    b = FakeBatcher(max_queue=64)
    slo = FakeSlo()
    c = _controller(reg, batcher=b, slo=slo, ladder_dwell=2,
                    shed_floor_frac=0.125)
    c.arm()
    try:
        shed = c.knobs["shed_depth"]
        assert (shed.lo, shed.hi) == (8, 64)
        slo.set_burn(20.0, 0.5)          # fast-burn alert bound crossed
        rungs = []
        for i in range(8):
            c.tick(now=100.0 + i)
            rungs.append(c.ladder.rung)
        # tightening first: 64 -> 32 -> 16 -> 8 while rung holds at 1,
        # then one rung per dwell — never a jump to the top
        assert b.max_queue == 8
        assert rungs[0] == RUNG_TIGHTEN_SHED
        assert rungs[-1] == RUNG_FAIL_STANCE
        assert [r for i, r in enumerate(rungs)
                if i and r > rungs[i - 1] + 1] == []
    finally:
        c.disarm()


def test_ladder_deescalates_and_relaxes_shed_when_burn_clears():
    reg = Registry()
    b = FakeBatcher(max_queue=64)
    slo = FakeSlo()
    c = _controller(reg, batcher=b, slo=slo, ladder_dwell=2,
                    ladder_clear=2)
    c.arm()
    try:
        slo.set_burn(20.0, 0.5)
        for i in range(8):
            c.tick(now=100.0 + i)
        assert c.ladder.rung == RUNG_FAIL_STANCE
        slo.set_burn(0.2, 0.2)           # burn under 1.0 on both windows
        for i in range(30):
            c.tick(now=200.0 + i)
        assert c.ladder.rung == RUNG_NORMAL
        assert b.max_queue == 64         # shed relaxed back to hi
    finally:
        c.disarm()


def test_ladder_ignores_warning_zone_between_clear_and_alert():
    reg = Registry()
    b = FakeBatcher(max_queue=64)
    slo = FakeSlo()
    c = _controller(reg, batcher=b, slo=slo)
    c.arm()
    try:
        slo.set_burn(3.0, 0.8)           # elevated but under 14.4/6
        for i in range(20):
            c.tick(now=100.0 + i)
        assert c.ladder.rung == RUNG_NORMAL
        assert b.max_queue == 64
    finally:
        c.disarm()


def test_ladder_clamps_and_records_history():
    ladder = DegradationLadder()
    ladder.set(99, "clamped high")
    assert ladder.rung == RUNG_FAIL_STANCE
    ladder.set(-5, "clamped low")
    assert ladder.rung == RUNG_NORMAL
    assert ladder.set(RUNG_NORMAL, "no-op") is False
    assert ladder.transitions == 2
    assert [h["to"] for h in ladder.history] == [RUNG_FAIL_STANCE,
                                                 RUNG_NORMAL]


# ------------------------------------------------------------ fan-out


def test_fanout_scales_up_on_duty_down_on_idle():
    reg = Registry()
    eng = FakeEngines(ids=("1", "2"))
    c = _controller(reg, engines=eng, fanout_cooldown_s=0.0)
    eng._total = 2                       # one child parked already
    c.arm()
    try:
        reg.gauge_set("gatekeeper_tpu_device_duty_cycle", "h", 0.9,
                      engine="1")
        c.tick(now=100.0)
        assert eng.calls[-1] == 3        # engine-bound: unpark
        reg.gauge_set("gatekeeper_tpu_device_duty_cycle", "h", 0.01,
                      engine="1")
        c.tick(now=200.0)                # idle duty, idle edge: park
        assert eng.calls[-1] == 2
        # never below 1 / above the configured fleet
        assert all(1 <= n <= 3 for n in eng.calls)
    finally:
        c.disarm()


def test_fanout_holds_scale_down_while_edge_busy():
    reg = Registry()
    eng = FakeEngines(ids=("1", "2"))
    c = _controller(reg, engines=eng, fanout_cooldown_s=0.0)
    c.arm()
    try:
        reg.gauge_set("gatekeeper_tpu_device_duty_cycle", "h", 0.01,
                      engine="1")
        reg.gauge_set("gatekeeper_tpu_queue_depth", "h", 50,
                      queue="admission", engine="0")
        c.tick(now=100.0)                # idle engines but deep queue:
        assert eng.calls == []           # the edge still needs them
    finally:
        c.disarm()


# ------------------------------------------------------------ prewarm


def test_prewarm_fires_once_per_settled_generation():
    reg = Registry()
    gens = iter([5, 5, 5, 6, 6, 6])
    fired = []
    done = threading.Event()

    def prewarm():
        fired.append(1)
        done.set()
        return 3

    c = _controller(reg, generation=lambda: next(gens),
                    prewarm=prewarm, prewarm_cooldown_s=0.0)
    c.arm()
    try:
        c.tick(now=100.0)                # learn gen 5
        c.tick(now=101.0)                # settled: fire
        assert done.wait(5.0)
        c.tick(now=102.0)                # still settled: no refire
        done.clear()
        c.tick(now=103.0)                # gen 6 in flight: hold
        c.tick(now=104.0)                # settled again: fire
        assert done.wait(5.0)
        time.sleep(0.05)
        assert len(fired) == 2
        assert [a["knob"] for a in c.actuations()].count("prewarm") == 2
    finally:
        c.disarm()


# ------------------------------------------------- kill switch / views


def test_disarm_restores_every_knob_bit_exactly():
    reg = Registry()
    b = FakeBatcher(max_wait=0.0075, max_batch=192, max_queue=64)
    slo = FakeSlo()
    c = _controller(reg, batcher=b, slo=slo)
    baseline = dict(b.knob_values())
    c.arm()
    _seed_seals(reg, "max_wait", 10, fill=0.01)
    slo.set_burn(20.0, 0.5)
    c.tick(now=100.0)
    c.tick(now=200.0)
    assert b.knob_values() != baseline   # the controller moved knobs
    assert c.ladder.rung > RUNG_NORMAL
    c.disarm()
    assert b.knob_values() == baseline   # bit-exact values restored
    assert b.max_wait == 0.0075
    assert c.ladder.rung == RUNG_NORMAL
    restores = [a for a in c.actuations()
                if a["direction"] == "restore"]
    assert restores
    # idempotent: a second disarm is a no-op
    c.disarm()


def test_on_actuate_hook_sees_every_landed_actuation():
    reg = Registry()
    b = FakeBatcher(max_wait=0.008)
    seen = []
    c = _controller(reg, batcher=b, on_actuate=seen.append)
    c.arm()
    try:
        _seed_seals(reg, "max_wait", 10, fill=0.01)
        c.tick(now=100.0)
        assert [a.knob for a in seen] == ["batch_max_wait"]
    finally:
        c.disarm()
    assert any(a.direction == "restore" for a in seen)


def test_status_payload_shape():
    reg = Registry()
    b = FakeBatcher()
    c = _controller(reg, batcher=b)
    c.arm()
    try:
        c.tick(now=100.0)
        st = c.status()
        assert st["armed"] is True and st["ticks"] == 1
        assert set(st["knobs"]) == {"batch_max_wait",
                                    "batch_max_batch", "shed_depth"}
        assert st["ladder"]["name"] == "normal"
        assert "signals" in st and "flip_count" in st
    finally:
        c.disarm()


def test_unbounded_shed_queue_parks_the_knob():
    reg = Registry()
    b = FakeBatcher(max_queue=0)         # 0 = unbounded
    slo = FakeSlo()
    c = _controller(reg, batcher=b, slo=slo)
    c.arm()
    try:
        slo.set_burn(50.0, 50.0)
        for i in range(10):
            c.tick(now=100.0 + i)
        assert b.max_queue == 0          # no tightening of "no bound"
    finally:
        c.disarm()


# ------------------------------------- ValidationHandler ladder gates


def _policy_client():
    client = Backend(RegoDriver()).new_client([K8sValidationTarget()])
    client.add_template({
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
    })
    client.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "K8sNeedOwner", "metadata": {"name": "need-owner"},
        "spec": {}})
    return client


def _review(name, username="adaptive-test"):
    obj = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": name, "namespace": "d",
                        "labels": {"owner": "me"}}}
    request = {"uid": f"uid-{name}", "operation": "CREATE",
               "kind": {"group": "", "version": "v1", "kind": "Pod"},
               "name": name, "namespace": "d",
               "userInfo": {"username": username}, "object": obj}
    return {"apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview", "request": request}


def test_fail_stance_rung_answers_without_evaluation():
    client = _policy_client()
    ladder = DegradationLadder()
    for fail_closed, want_allowed in ((False, True), (True, False)):
        batcher = MicroBatcher(client)
        handler = ValidationHandler(client, batcher=batcher,
                                    fail_closed=fail_closed,
                                    ladder=ladder)
        try:
            ladder.set(RUNG_FAIL_STANCE, "test")
            out = handler.handle(_review("p1"))
            assert out["response"]["allowed"] is want_allowed
            assert out["response"]["status"]["code"] == 429
            # the exemption that keeps the cluster repairable survives
            # the bottom rung
            sa = handler.handle(_review("p2", username=SERVICE_ACCOUNT))
            assert sa["response"]["allowed"] is True
            assert "status" not in sa["response"] or \
                sa["response"]["status"].get("code") != 429
        finally:
            ladder.set(RUNG_NORMAL, "test")
            batcher.stop()


def test_cache_only_rung_serves_hits_sheds_misses():
    client = _policy_client()
    ladder = DegradationLadder()
    batcher = MicroBatcher(client)
    handler = ValidationHandler(client, batcher=batcher, ladder=ladder)
    try:
        warm = _review("cached-pod")
        out = handler.handle(warm)       # rung 0: evaluated + cached
        assert out["response"]["allowed"] is True
        ladder.set(RUNG_CACHE_ONLY, "test")
        hit = handler.handle(warm)       # hit still serves at speed
        assert hit["response"]["allowed"] is True
        assert (hit["response"].get("status") or {}).get("code") != 429
        miss = handler.handle(_review("never-seen"))
        assert miss["response"]["status"]["code"] == 429
    finally:
        ladder.set(RUNG_NORMAL, "test")
        batcher.stop()


def test_cache_only_rung_sheds_when_cache_disabled():
    client = _policy_client()
    ladder = DegradationLadder()
    batcher = MicroBatcher(client)
    handler = ValidationHandler(client, batcher=batcher, ladder=ladder,
                                decision_cache_size=0)
    try:
        ladder.set(RUNG_CACHE_ONLY, "test")
        out = handler.handle(_review("p1"))
        assert out["response"]["status"]["code"] == 429
    finally:
        ladder.set(RUNG_NORMAL, "test")
        batcher.stop()


# ------------------------------------------- live MicroBatcher knobs


def test_microbatcher_set_knobs_live_and_floored():
    client = _policy_client()
    b = MicroBatcher(client, max_wait=0.005, max_batch=256,
                     max_queue=64)
    try:
        out = b.set_knobs(max_wait=0.001, max_batch=512, max_queue=32)
        assert out == {"max_wait": 0.001, "max_batch": 512,
                       "max_queue": 32}
        assert b.knob_values() == out
        # garbage replication frames clamp at the sanity floors
        out = b.set_knobs(max_wait=-1.0, max_batch=0, max_queue=-5)
        assert out == {"max_wait": 0.0, "max_batch": 1, "max_queue": 0}
        # a retuned batcher still serves
        res = b.submit({"object": {"apiVersion": "v1", "kind": "Pod",
                                   "metadata": {"name": "x",
                                                "labels":
                                                    {"owner": "me"}}}},
                       timeout=10.0)
        assert res == []
    finally:
        b.stop()


# ------------------------------------------ EngineSupervisor fan-out


def test_engine_supervisor_scale_clamps_and_tracks_desired():
    sup = EngineSupervisor([1, 2, 3], lambda k: f"/tmp/na-{k}.sock")
    assert sup.active_total() == 4
    assert sup.scale_to(99) == 4         # hard ceiling: configured fleet
    assert sup.scale_to(0) == 1          # engine 0 never parks
    assert sup.active_total() == 1
    assert sup.scale_to(2) == 2
    assert sup._active_ids() == {1}      # prefix of the configured list
    sup.set_knobs({"max_wait": 0.002})
    assert sup._knobs_gen == 1
    sup.set_knobs({"max_wait": 0.004})
    assert sup._knobs_gen == 2


# -------------------------------------------------- metric hygiene


def test_adaptive_metric_labels_fold_unknowns():
    metrics.report_adaptive_actuation("bogus_knob", "sideways")
    snap = metrics.REGISTRY.snapshot(
        ("gatekeeper_tpu_adaptive_actuations_total",))
    ent = snap["gatekeeper_tpu_adaptive_actuations_total"]
    folded = [tuple(k) for k, _ in ent["values"]
              if "other" in tuple(k)]
    assert (("other", "other") in folded
            or ("other",) in [f for f in folded])
    metrics.report_degradation_rung(99)  # clamps to the top rung
    snap = metrics.REGISTRY.snapshot(
        ("gatekeeper_tpu_degradation_rung",))
    vals = snap["gatekeeper_tpu_degradation_rung"]["values"]
    assert vals and vals[0][1] == 3.0
    metrics.report_degradation_rung(0)


# ------------------------------------- the port against the JAX package

def _adaptive_transcript(adaptive_mod, registry_cls) -> list:
    """One package's AdaptiveController over one scripted run: batch
    seals, a fast burn then its clearing, engine duty and an idle
    edge; per tick the knobs, the rung and the fan-out, then the
    actuations and the ladder's history, and the baselines after the
    disarm."""
    reg = registry_cls()
    b = FakeBatcher(max_wait=0.008, max_batch=128, max_queue=64)
    eng = FakeEngines(ids=("1", "2"))
    slo = FakeSlo()
    c = adaptive_mod.AdaptiveController(
        registry=reg, batcher=b, engines=eng, slo=slo, interval=999.0,
        cooldown_s=0.0, hysteresis_s=0.0, fanout_cooldown_s=0.0,
        ladder_dwell=2, ladder_clear=2)
    c.arm()
    out = []
    try:
        for i in range(40):
            if i < 6:
                _seed_seals(reg, "max_wait" if i % 2 else "full", 5,
                            fill=0.01 if i % 2 else 1.0)
            slo.set_burn(20.0, 0.5) if 8 <= i < 16 else \
                slo.set_burn(0.2, 0.2)
            reg.gauge_set("gatekeeper_tpu_device_duty_cycle", "h",
                          0.9 if i < 20 else 0.01, engine="1")
            c.tick(now=100.0 + 10 * i)
            out.append([b.knob_values(), c.ladder.rung, eng._total])
        out.append([{k: v for k, v in a.items() if k not in ("t", "ts")}
                    for a in c.actuations()])
        out.append([{k: v for k, v in h.items() if k not in ("t", "ts")}
                    for h in c.ladder.history])
    finally:
        c.disarm()
    out.append([b.knob_values(), eng._total])
    return out


def test_controller_transcript_equals_the_jax_package():
    """The adaptive controller (a verbatim copy) takes the same
    actuations, rungs and fan-out on the same signals in both
    packages, and restores the same baselines."""
    from gatekeeper_tpu.control import adaptive as jadaptive
    from gatekeeper_tpu.control.metrics import Registry as JRegistry
    from gatekeeper_tpu_torch.control import adaptive as tadaptive

    got = _adaptive_transcript(tadaptive, Registry)
    want = _adaptive_transcript(jadaptive, JRegistry)
    assert got == want
    assert got[-3] and got[-2]  # it actuated and the ladder moved
    assert got[-1] == [{"max_wait": 0.008, "max_batch": 128,
                        "max_queue": 64}, 3]
