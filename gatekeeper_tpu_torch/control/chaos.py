"""Seeded chaos orchestration + crash-consistency verification.

PRs 3/4/7/16/18 each shipped a one-off chaos leg (engine kill, kill -9
mid-sweep, shard kill, controller-under-kill) scattered across five
test files — all clean deaths, none replayable, no single place that
asserts the plane's global invariants after an arbitrary fault
sequence. This module is that place:

  * `ChaosSchedule.generate(seed, ...)` — a fault schedule derived
    DETERMINISTICALLY from one integer seed: same seed, same kinds,
    same targets, same offsets, same parameters. Every run prints the
    seed so any failure replays exactly (`tools/chaos_verify.py
    --seed N`).
  * `ChaosOrchestrator` — executes a schedule against live plane
    handles (the three supervisors, the FakeKube stub, the fault
    injector, /dev/shm) and keeps a ledger of what actually fired,
    exposed on `/debug/chaos` together with the injector's
    armed/fired snapshots.
  * `Verifier` — the crash-consistency checks run after every
    schedule: zero unanswered admissions with every verdict matching
    the stance contract, post-convergence audit round bit-equal to a
    clean oracle, at most one lease holder ever writing status
    (fencing), no leaked processes/fds//dev/shm segments, and no
    stale lifecycle gauges (the gklint gauge-teardown family list,
    checked at RUNTIME after teardown).

The schedule is deterministic; the plane's *response* (which child was
alive to kill, how long recovery took) is not — that asymmetry is the
point: one fixed sequence of inputs, invariants over any interleaving
of outcomes.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..utils.faults import FAULTS
from . import shm
from .logging import logger

log = logger("chaos")


# ------------------------------------------------------------- schedule


@dataclass(frozen=True)
class FaultAction:
    """One scheduled fault: fire `kind` against child slot `target`
    (resolved modulo the live children at fire time) at `t` seconds
    after the schedule starts. `param`/`count` carry kind-specific
    shape (an errno flavor, an armed-fault fire budget)."""

    t: float
    kind: str
    target: int = 0
    param: str = ""
    count: int = 1

    def to_dict(self) -> dict:
        return {"t": round(self.t, 3), "kind": self.kind,
                "target": self.target, "param": self.param,
                "count": self.count}


# the full fault surface; schedules draw from a subset of these kinds.
# process-level kinds act on supervisor children (SIGKILL / SIGSTOP);
# the rest arm utils/faults points or poke the FakeKube / /dev/shm.
SURFACE = (
    "engine.kill", "engine.pause",
    "frontend.kill", "frontend.pause",
    "shard.kill", "shard.pause",
    "wire.reset", "wire.truncate", "wire.slow",
    "backplane.error",
    "kube.flap", "kube.stall",
    "lease.steal", "lease.expire",
    "state.disk", "state.corrupt",
    "shm.corrupt", "shm.unlink",
)

_PARAMS = {
    "wire.slow": ("0.02", "0.05"),
    "state.disk": ("enospc", "eio"),
    "kube.flap": ("429", "410", "503"),
    "state.corrupt": ("corrupt", "truncate"),
}


class ChaosSchedule:
    """A deterministic fault schedule: (seed, surface, n, horizon) in,
    the same ordered FaultAction list out, every time."""

    def __init__(self, seed: int, actions: list):
        self.seed = int(seed)
        self.actions = list(actions)

    @classmethod
    def generate(cls, seed: int, surface=SURFACE, n_actions: int = 8,
                 horizon_s: float = 10.0,
                 max_target: int = 4) -> "ChaosSchedule":
        """Derive a schedule from one integer seed. All randomness
        comes from a private Random(seed) — nothing reads the global
        RNG or the clock, so replay is exact by construction."""
        rng = random.Random(int(seed))
        surface = tuple(surface)
        actions = []
        for _ in range(n_actions):
            kind = surface[rng.randrange(len(surface))]
            params = _PARAMS.get(kind)
            actions.append(FaultAction(
                t=round(rng.uniform(0.0, horizon_s), 3),
                kind=kind,
                target=rng.randrange(max_target),
                param=params[rng.randrange(len(params))] if params
                else "",
                count=1 + rng.randrange(3),
            ))
        actions.sort(key=lambda a: (a.t, a.kind, a.target))
        return cls(seed, actions)

    def to_dict(self) -> dict:
        return {"seed": self.seed,
                "actions": [a.to_dict() for a in self.actions]}


# ---------------------------------------------------------- plane handles


@dataclass
class PlaneHandles:
    """Duck-typed handles the orchestrator acts through. Any of them
    may be None — a schedule against a partial plane simply records
    the skipped actions in the ledger (the verifier does NOT treat a
    skip as a violation; an all-skip schedule exercises nothing)."""

    frontends: Any = None     # FrontendSupervisor
    engines: Any = None       # EngineSupervisor
    audit_shards: Any = None  # AuditShardSupervisor
    kube: Any = None          # FakeKube
    shm_prefix: str = "gk-bp-"


# --------------------------------------------------------- orchestrator


class ChaosOrchestrator:
    """Executes one schedule against live plane handles, recording a
    ledger of what fired. `run()` is synchronous (the verify harness
    owns the load threads); `start()` wraps it in a thread."""

    def __init__(self, plane: PlaneHandles, schedule: ChaosSchedule,
                 time_scale: float = 1.0):
        self.plane = plane
        self.schedule = schedule
        # compresses/stretches the schedule's t offsets (CI runs the
        # same schedule faster than a soak would)
        self.time_scale = time_scale
        self.ledger: list[dict] = []
        self._ledger_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._t0: Optional[float] = None

    # ------------------------------------------------------------- run

    def run(self) -> list[dict]:
        global _ACTIVE
        _ACTIVE = self
        log.info("chaos schedule starting",
                 details={"seed": self.schedule.seed,
                          "actions": len(self.schedule.actions)})
        self._t0 = time.monotonic()
        for action in self.schedule.actions:
            due = self._t0 + action.t * self.time_scale
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            try:
                detail = self._fire(action)
            except Exception as e:  # a fault action must never kill
                detail = {"error": repr(e)}  # the orchestrator itself
            self._log(action, detail)
        return list(self.ledger)

    def start(self) -> threading.Thread:
        self._thread = threading.Thread(target=self.run,
                                        name="chaos-orchestrator",
                                        daemon=True)
        self._thread.start()
        return self._thread

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def _log(self, action: FaultAction, detail: dict) -> None:
        ent = dict(action.to_dict())
        ent["at_s"] = round(time.monotonic() - self._t0, 3)
        ent["detail"] = detail
        with self._ledger_lock:
            self.ledger.append(ent)

    # ----------------------------------------------------------- actions

    @staticmethod
    def _slot(sup, target: int):
        """Resolve a schedule target index onto the supervisor's live
        children (modulo), or None when none are up."""
        pids = sup.child_pids() if sup is not None else {}
        if not pids:
            return None
        keys = sorted(pids)
        return keys[target % len(keys)]

    def _fire(self, a: FaultAction) -> dict:
        p = self.plane
        domain, _, verb = a.kind.partition(".")
        if domain == "engine":
            k = self._slot(p.engines, a.target)
            if k is None:
                return {"skipped": "no live engine child"}
            (p.engines.kill_engine if verb == "kill"
             else p.engines.pause_engine)(k)
            return {"engine": k, "signal":
                    "SIGKILL" if verb == "kill" else "SIGSTOP"}
        if domain == "frontend":
            k = self._slot(p.frontends, a.target)
            if k is None:
                return {"skipped": "no live frontend"}
            (p.frontends.kill_child if verb == "kill"
             else p.frontends.pause_child)(k)
            return {"worker": k, "signal":
                    "SIGKILL" if verb == "kill" else "SIGSTOP"}
        if domain == "shard":
            k = self._slot(p.audit_shards, a.target)
            if k is None:
                return {"skipped": "no live audit shard"}
            (p.audit_shards.kill_engine if verb == "kill"
             else p.audit_shards.pause_engine)(k)
            return {"shard": k, "signal":
                    "SIGKILL" if verb == "kill" else "SIGSTOP"}
        if domain == "wire":
            FAULTS.inject("backplane.wire", mode=verb, param=a.param,
                          count=a.count)
            return {"armed": f"backplane.wire:{verb}",
                    "count": a.count}
        if a.kind == "backplane.error":
            FAULTS.inject("backplane.engine", mode="error",
                          count=a.count)
            return {"armed": "backplane.engine:error", "count": a.count}
        if a.kind == "kube.flap":
            # an apiserver flap is not one error, it is WEATHER: rate-
            # limited writes, 410s on lists racing compaction, both at
            # a probability for a bounded budget, plus a real etcd-
            # style compaction so resumed watches see the 410 path
            code = a.param or "429"
            FAULTS.inject("kube.write", mode="error", param=code,
                          rate=0.5, count=a.count * 4)
            FAULTS.inject("kube.list", mode="error", param="410",
                          rate=0.5, count=a.count * 2)
            if p.kube is not None and hasattr(p.kube, "compact"):
                p.kube.compact()
            return {"armed": f"kube.write:{code} + kube.list:410",
                    "compacted": p.kube is not None}
        if a.kind == "kube.stall":
            FAULTS.inject("kube.list", mode="sleep", param="0.5",
                          sleep_s=0.5, count=a.count)
            return {"armed": "kube.list:sleep:0.5", "count": a.count}
        if domain == "lease":
            FAULTS.inject("kube.lease", mode=verb, count=1)
            return {"armed": f"kube.lease:{verb}"}
        if a.kind == "state.disk":
            FAULTS.inject("state.disk", mode="error",
                          param=a.param or "enospc", count=a.count)
            return {"armed": f"state.disk:{a.param}", "count": a.count}
        if a.kind == "state.corrupt":
            FAULTS.inject("state.snapshot",
                          mode=a.param or "corrupt", count=1)
            return {"armed": f"state.snapshot:{a.param}"}
        if domain == "shm":
            segs = shm.list_segments(p.shm_prefix)
            if not segs:
                return {"skipped": "no live shm segments"}
            name = segs[a.target % len(segs)]
            if verb == "unlink":
                shm.unlink(name)
                return {"unlinked": name}
            # stamp past the ring header region so the damage lands in
            # record space, not the allocator bookkeeping
            ok = shm.corrupt_segment(name, offset=64)
            return {"corrupted": name, "ok": ok}
        return {"skipped": f"unknown kind {a.kind}"}

    # ------------------------------------------------------------ debug

    def snapshot(self) -> dict:
        with self._ledger_lock:
            ledger = list(self.ledger)
        return {
            "seed": self.schedule.seed,
            "schedule": self.schedule.to_dict()["actions"],
            "ledger": ledger,
            "faults": {
                "armed": FAULTS.armed_snapshot(),
                "fired": FAULTS.fired_snapshot(),
            },
        }


# the most recent orchestrator, for /debug/chaos. With no schedule ever
# run the endpoint still answers with the injector's armed/fired state
# (an operator game-daying with GATEKEEPER_TPU_FAULTS sees what fired).
_ACTIVE: Optional[ChaosOrchestrator] = None


def debug_snapshot(query: str = "") -> dict:
    if _ACTIVE is not None:
        return _ACTIVE.snapshot()
    return {
        "seed": None,
        "schedule": [],
        "ledger": [],
        "faults": {
            "armed": FAULTS.armed_snapshot(),
            "fired": FAULTS.fired_snapshot(),
        },
    }


# --------------------------------------------------------- leak baseline


class LeakBaseline:
    """Before/after resource snapshot for the leak invariant: child
    pids (every tracked child must be DEAD after teardown), /dev/shm
    segments under the plane's prefix (must all be unlinked), and this
    process's fd count (bounded growth — reconnect churn may hold a
    few, a leak per request would not stay under the slack)."""

    def __init__(self, plane: PlaneHandles, fd_slack: int = 16):
        self.plane = plane
        self.fd_slack = fd_slack
        self.pids: set = set()
        self.fds = 0
        self.shm_before: set = set()

    @staticmethod
    def _fd_count() -> int:
        try:
            return len(os.listdir("/proc/self/fd"))
        except OSError:
            return 0

    def capture(self) -> "LeakBaseline":
        self.fds = self._fd_count()
        self.shm_before = set(shm.list_segments(self.plane.shm_prefix))
        return self

    def track_children(self) -> None:
        """Record every live child pid (call after boot AND after the
        schedule — respawned children get new pids)."""
        for sup in (self.plane.frontends, self.plane.engines,
                    self.plane.audit_shards):
            if sup is not None:
                self.pids.update(sup.child_pids().values())

    def violations(self) -> list[str]:
        out = []
        for pid in sorted(self.pids):
            try:
                os.kill(pid, 0)
            except OSError:
                continue  # dead (or not ours): not leaked
            out.append(f"leaked process: child pid {pid} still alive "
                       "after teardown")
        # only segments BORN during this run count: a stale segment
        # from an earlier crashed process is real debt, but not this
        # schedule's leak (sweep_stale owns that cleanup)
        after = set(shm.list_segments(self.plane.shm_prefix))
        for name in sorted(after - self.shm_before):
            out.append(f"leaked /dev/shm segment after teardown: "
                       f"{name}")
        fds = self._fd_count()
        if fds > self.fds + self.fd_slack:
            out.append(f"fd growth {self.fds} -> {fds} exceeds slack "
                       f"{self.fd_slack} (leaked sockets/pipes)")
        return out


# ------------------------------------------------------- fencing records


class RecordingKube:
    """Kube wrapper for the fencing invariant: forwards every call to
    the inner client, and records each SUCCESSFUL status write as
    (t_monotonic, identity, lease holder at write time) into a shared
    log. The verifier then asserts every status write was made by the
    then-current lease holder — the at-most-one-writer fence."""

    def __init__(self, inner, identity: str, writes: list,
                 lease_name: str = "gatekeeper-tpu-leader",
                 lease_namespace: str = "gatekeeper-system"):
        self._inner = inner
        self._identity = identity
        self._writes = writes  # shared, append-only
        self._lease_name = lease_name
        self._lease_ns = lease_namespace

    def _holder(self) -> str:
        try:
            lease = self._inner.get(
                ("coordination.k8s.io", "v1", "Lease"),
                self._lease_name, self._lease_ns)
            return (lease.get("spec") or {}).get("holderIdentity") or ""
        except Exception:
            return ""

    def update(self, obj, subresource: str = ""):
        out = self._inner.update(obj, subresource=subresource)
        if subresource == "status":
            self._writes.append((time.monotonic(), self._identity,
                                 self._holder()))
        return out

    def __getattr__(self, name):
        return getattr(self._inner, name)


# ------------------------------------------------------------- verifier

# fallback copy of the gklint lifecycle gauge families, used only when
# tools.gklint is not importable at runtime (installed package without
# the repo checkout); the import path is authoritative
_LIFECYCLE_GAUGES_FALLBACK = (
    "gatekeeper_tpu_queue_depth",
    "gatekeeper_tpu_device_duty_cycle",
    "gatekeeper_tpu_backplane_inflight",
    "gatekeeper_tpu_backplane_ring_fill_ratio",
    "gatekeeper_tpu_audit_stream_pending_events",
    "gatekeeper_tpu_slo_burn_rate",
    "gatekeeper_tpu_respawn_backoff_seconds",
    "gatekeeper_tpu_crashloop_breaker",
)


def lifecycle_gauge_names() -> tuple:
    """The gklint gauge-teardown family list, imported at runtime so
    the dynamic stale-gauge check and the static lint can never drift
    apart."""
    try:
        from tools.gklint.gauge_teardown import LIFECYCLE_GAUGE_NAMES
        return tuple(sorted(LIFECYCLE_GAUGE_NAMES))
    except ImportError:
        return _LIFECYCLE_GAUGES_FALLBACK


@dataclass
class CheckResult:
    name: str
    violations: list = field(default_factory=list)
    detail: dict = field(default_factory=dict)
    skipped: str = ""

    @property
    def ok(self) -> bool:
        return not self.violations


class Verifier:
    """Crash-consistency checks, one method per global invariant. Each
    returns (and records) a CheckResult; `report()` renders the whole
    run. A check against an absent subsystem records itself skipped
    with the reason — never silently."""

    def __init__(self):
        self.results: list[CheckResult] = []

    def _add(self, r: CheckResult) -> CheckResult:
        self.results.append(r)
        return r

    # 1 -------------------------------------------------------- answers

    def check_admissions(self, submitted: int, answered: dict,
                         errors: list,
                         fail_closed: bool = False) -> CheckResult:
        """Every submitted admission got exactly one AdmissionReview
        envelope, and every verdict matches the stance contract: a
        stance answer (status.code 503, issued when the engine was
        unreachable) must carry allowed == (not fail_closed); a real
        verdict carries a boolean `allowed` and never the NOT_READY
        internal status."""
        r = CheckResult("admissions",
                        detail={"submitted": submitted,
                                "answered": len(answered),
                                "transport_errors": len(errors)})
        for i, err in list(errors)[:5]:
            r.violations.append(
                f"admission {i} unanswered (transport error: {err})")
        if len(errors) > 5:
            r.violations.append(
                f"... and {len(errors) - 5} more transport errors")
        if len(answered) + len(errors) < submitted:
            r.violations.append(
                f"{submitted - len(answered) - len(errors)} admissions "
                "vanished without an answer OR an error")
        stance = 0
        for uid, (status, body) in answered.items():
            resp = (body or {}).get("response") or {}
            if resp.get("uid") != uid:
                r.violations.append(
                    f"admission {uid}: envelope uid mismatch "
                    f"({resp.get('uid')!r})")
                continue
            allowed = resp.get("allowed")
            if not isinstance(allowed, bool):
                r.violations.append(
                    f"admission {uid}: non-boolean allowed "
                    f"({allowed!r})")
                continue
            code = ((resp.get("status") or {}).get("code")
                    if isinstance(resp.get("status"), dict) else None)
            if code == 599:
                r.violations.append(
                    f"admission {uid}: internal NOT_READY status "
                    "leaked to an HTTP caller")
            elif code in (503, 504):
                stance += 1
                if allowed is not (not fail_closed):
                    r.violations.append(
                        f"admission {uid}: stance answer allowed="
                        f"{allowed} contradicts fail_closed="
                        f"{fail_closed}")
        r.detail["stance_answers"] = stance
        return self._add(r)

    # 2 ----------------------------------------------------- audit oracle

    def check_audit_bitequal(self, chaotic: Any,
                             oracle: Any) -> CheckResult:
        """The post-convergence audit round (sharded plane, after the
        schedule and every respawn/resync settled) must be BIT-EQUAL
        to a clean single-process oracle over the same cluster state:
        canonical-JSON equality, not set-similarity — a re-swept
        orphaned partition that double-counts or drops one violation
        fails here."""
        r = CheckResult("audit_bitequal")
        a = json.dumps(chaotic, sort_keys=True, default=str)
        b = json.dumps(oracle, sort_keys=True, default=str)
        r.detail["bytes"] = len(a)
        if a != b:
            r.violations.append(
                "post-convergence audit round differs from the clean "
                f"oracle ({len(a)} vs {len(b)} canonical bytes)")
        return self._add(r)

    # 3 --------------------------------------------------------- fencing

    def check_fencing(self, writes: list,
                      writers: Optional[set] = None) -> CheckResult:
        """At most one lease holder ever writes status. RecordingKube
        entries are (t, identity, holder-at-write-time); the violation
        is a write by one CANDIDATE while a DIFFERENT candidate held
        the lease — two fenced writers live at once. A holder outside
        `writers` (a fault-injected thief, or the brief stale window
        before the deposed candidate's next renew tick notices) never
        has a second writer behind it, so it is recorded in the detail
        but is not a violation; with writers=None every mismatch is."""
        r = CheckResult("lease_fencing",
                        detail={"status_writes": len(writes)})
        mismatches = 0
        for t, identity, holder in writes:
            if identity == holder:
                continue
            mismatches += 1
            if writers is None or holder in writers:
                r.violations.append(
                    f"status write by {identity!r} at t={t:.3f} while "
                    f"lease holder was {holder!r}")
        r.detail["holder_mismatches"] = mismatches
        return self._add(r)

    # 4 ----------------------------------------------------------- leaks

    def check_leaks(self, baseline: LeakBaseline) -> CheckResult:
        r = CheckResult("resource_leaks",
                        detail={"tracked_pids": len(baseline.pids)})
        r.violations.extend(baseline.violations())
        return self._add(r)

    # 5 ---------------------------------------------------- stale gauges

    def check_stale_gauges(self) -> CheckResult:
        """After full plane teardown every lifecycle-bound gauge series
        (the gklint gauge-teardown families, read at runtime) must be
        zero: a non-zero series is a dead component still exporting."""
        from . import metrics

        r = CheckResult("stale_gauges")
        families = lifecycle_gauge_names()
        r.detail["families"] = len(families)
        for name in families:
            for labels, value in sorted(metrics.gauge_series(name)
                                        .items()):
                if value:
                    r.violations.append(
                        f"stale gauge after teardown: {name}"
                        f"{dict(zip(('labels',), (labels,)))} = "
                        f"{value}")
        return self._add(r)

    # ------------------------------------------------------------ report

    def violation_count(self) -> int:
        return sum(len(r.violations) for r in self.results)

    def report(self) -> dict:
        return {
            "checks": [
                {"name": r.name, "ok": r.ok, "skipped": r.skipped,
                 "violations": r.violations, "detail": r.detail}
                for r in self.results
            ],
            "invariant_violations": self.violation_count(),
        }
