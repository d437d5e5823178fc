"""The port's compile lifecycle (TorchDriver's quarantine breaker and
async warm-up) against the JAX package's TpuDriver.

The same fault sequence goes through each package's own FAULTS (or the
same monkeypatched failure at the same seam), on the CPU: the port with
its kernels' plain versions, TpuDriver on JAX's CPU backend. Each test
requires equal results, equal quarantine_status() keys and failure
counts, and equal per-kind eval paths (the audit's eval counts; a review
batch's paths are the port's own count, held to what the reference's
quarantine state implies). Tolerance: exact equality. Timing is coarse
(backoffs of tenths of a second, sleeps past them), never a measurement.

One deliberate difference is pinned here: a join kind's half-open probe.
TpuDriver asks the breaker in compiled_for before join_for, so for a join
kind the lease is taken where no probe can run, and join_for then finds
a probe in flight; the kind stays on the interpreter. The port lets only
join_for take a join kind's lease, and its probe restores K4.
"""

import threading
import time

import pytest

from gatekeeper_tpu import policies as jpol
from gatekeeper_tpu.client import Backend as JBackend
from gatekeeper_tpu.ir import TpuDriver
from gatekeeper_tpu.ir import evaljax as jeval
from gatekeeper_tpu.ir import join as jjoin
from gatekeeper_tpu.target import K8sValidationTarget as JTarget
from gatekeeper_tpu.utils.faults import FAULTS as JFAULTS
from gatekeeper_tpu_torch import policies as tpol
from gatekeeper_tpu_torch.client import Backend as TBackend
from gatekeeper_tpu_torch.client import RegoDriver as TRegoDriver
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.ir import evaltorch as teval
from gatekeeper_tpu_torch.ir import join as tjoin
from gatekeeper_tpu_torch.kernels import build as kernel_build
from gatekeeper_tpu_torch.target import K8sValidationTarget as TTarget
from gatekeeper_tpu_torch.utils.faults import FAULTS as TFAULTS

from .test_torch_frontend import fixture_objects
from .test_torch_join import JOINS, with_duplicates

TARGET = "admission.k8s.gatekeeper.sh"
# (package tag, Backend, target, driver factory, FAULTS, policies)
SIDES = (("jax", JBackend, JTarget, TpuDriver, JFAULTS, jpol),
         ("torch", TBackend, TTarget,
          lambda: TorchDriver(device="cpu"), TFAULTS, tpol))

NEED_OWNER = """
package k8sneedowner
violation[{"msg": "no owner label"}] {
  not input.review.object.metadata.labels.owner
}
"""
NEED_TEAM = """
package k8sneedteam
violation[{"msg": "no team label"}] {
  not input.review.object.metadata.labels.team
}
"""


@pytest.fixture(autouse=True)
def _clean_faults():
    """No armed fault leaks into the next test, in either package."""
    JFAULTS.reset()
    TFAULTS.reset()
    yield
    JFAULTS.reset()
    TFAULTS.reset()


def template(kind: str, rego: str) -> dict:
    return {"apiVersion": "templates.gatekeeper.sh/v1beta1",
            "kind": "ConstraintTemplate",
            "metadata": {"name": kind.lower()},
            "spec": {"crd": {"spec": {"names": {"kind": kind}}},
                     "targets": [{"target": TARGET, "rego": rego}]}}


def constraint(kind: str, name: str, params=None) -> dict:
    return {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind, "metadata": {"name": name},
            "spec": ({"parameters": params} if params else {})}


def policy_client(side, team: bool = False):
    """(driver, client) with K8sNeedOwner (and K8sNeedTeam), as
    tests/test_resilience.py's _policy_client builds it."""
    _tag, backend, target, make, _faults, _pol = side
    drv = make()
    if isinstance(drv, TpuDriver):
        drv._mesh = None
    client = backend(drv).new_client([target()])
    client.add_template(template("K8sNeedOwner", NEED_OWNER))
    client.add_constraint(constraint("K8sNeedOwner", "need-owner"))
    if team:
        client.add_template(template("K8sNeedTeam", NEED_TEAM))
        client.add_constraint(constraint("K8sNeedTeam", "need-team"))
    return drv, client


def key(results):
    return [(r.msg, r.constraint["metadata"]["name"],
             (r.resource or {}).get("metadata", {}).get("name"),
             r.enforcement_action) for r in results]


def status(drv) -> dict:
    """quarantine_status() as kind -> fails (the reason and the time left
    are free text and a clock)."""
    return {k: v["fails"] for k, v in drv.quarantine_status().items()}


def evals(drv) -> dict:
    return dict(drv._eval_counts)


def namespaces(n: int) -> list[dict]:
    return [{"apiVersion": "v1", "kind": "Namespace",
             "metadata": {"name": f"n{i}"}} for i in range(n)]


def pod_review(name: str) -> dict:
    return {"uid": f"uid-{name}", "operation": "CREATE",
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "name": name, "namespace": "d",
            "userInfo": {"username": "chaos"},
            "object": {"apiVersion": "v1", "kind": "Pod",
                       "metadata": {"name": name, "namespace": "d"}}}


def wait_warm(drv, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while drv.warm_status()["compiling"] and time.monotonic() < deadline:
        time.sleep(0.02)
    assert drv.warm_status()["compiling"] == 0, "the warm never drained"


def wait_for(cond, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert cond()


def pin_device(drv) -> None:
    """The cost model prefers the device (the reference's tests pin it
    so)."""
    drv._dev_batch_lat_s = 1e-4
    drv._host_pair_rate = 1.0


# ------------------------------------------------- device-eval quarantine


def test_eval_failure_quarantines_template_and_interp_serves():
    """tests/test_resilience.py's test of the same name through both
    packages; its metrics-registry lines become an on_quarantine
    observer: one call with the reason at the quarantine, one with None
    at the recovery."""
    steps = []
    for side in SIDES:
        faults = side[4]
        driver, client = policy_client(side)
        for o in namespaces(6):
            client.add_data(o)
        notes = []
        driver.on_quarantine = lambda kind, why: notes.append((kind, why))
        driver.quarantine_base_s = 0.3
        faults.inject("eval.device", mode="raise",
                      match={"kind": "K8sNeedOwner"})
        first = key(client.audit().results())
        assert len(first) == 6  # availability held: the interpreter
        q = status(driver)
        assert q == {"K8sNeedOwner": 1}
        wait_for(lambda: len(notes) == 1)
        assert notes[0][0] == "K8sNeedOwner" and \
            notes[0][1].startswith("audit-eval: FaultError")
        # while quarantined, the device path is not even attempted
        fired = faults.fired("eval.device")
        second = key(client.audit().results())
        assert faults.fired("eval.device") == fired
        q2 = status(driver)
        # storm ends; after the backoff the half-open probe restores the
        # device path and clears the quarantine
        faults.clear("eval.device")
        time.sleep(0.35)
        pin_device(driver)
        third = key(client.audit().results())
        assert driver.quarantine_status() == {}
        wait_for(lambda: len(notes) == 2)
        assert notes[1] == ("K8sNeedOwner", None)
        steps.append((first, second, q, q2, third, evals(driver)))
    want, got = steps
    assert got == want
    assert got[-1] == {("K8sNeedOwner", "interp"): 2,
                       ("K8sNeedOwner", "device"): 1}


def test_quarantine_half_open_allows_single_probe():
    """After the backoff expires, exactly ONE caller takes the probe
    lease; concurrent callers stay on the interpreter. A probe failure
    re-quarantines with a doubled backoff."""
    traces = []
    for side in SIDES:
        driver, _client = policy_client(side)
        driver.quarantine_base_s = 0.01
        driver._quarantine_kind("K8sNeedOwner", "review-eval",
                                RuntimeError("injected"))
        time.sleep(0.05)  # backoff expired: half-open
        trace = [driver._quarantined("K8sNeedOwner"),  # takes the lease
                 driver._quarantined("K8sNeedOwner"),  # probe in flight
                 driver.compiled_for("K8sNeedOwner") is None]
        driver._quarantine_kind("K8sNeedOwner", "review-eval",
                                RuntimeError("probe failed"))
        trace += [driver._quarantined("K8sNeedOwner"), status(driver)]
        traces.append(trace)
    assert traces[0] == traces[1] == [False, True, True, True,
                                      {"K8sNeedOwner": 2}]


def _lease_expiry(driver):
    driver.quarantine_base_s = 0.01
    driver.QUARANTINE_PROBE_LEASE_S = 0.1
    driver._quarantine_kind("K8sNeedOwner", "audit-eval", RuntimeError("x"))
    time.sleep(0.05)
    out = [driver._quarantined("K8sNeedOwner"),   # takes the lease
           driver._quarantined("K8sNeedOwner")]   # lease held
    time.sleep(0.15)  # the probe never resolved: its lease lapses
    out += [driver._quarantined("K8sNeedOwner"),  # a new probe takes it
            driver._quarantined("K8sNeedOwner"), status(driver)]
    return out


def _backoff_resumes(driver):
    driver.quarantine_base_s = 0.01
    driver.quarantine_max_s = 0.3
    out = []
    for _ in range(2):
        driver._quarantine_kind("K8sNeedOwner", "audit-eval",
                                RuntimeError("x"))
        out.append(status(driver))
        time.sleep(0.05)
        out.append(driver._quarantined("K8sNeedOwner"))
        driver._quarantine_clear("K8sNeedOwner")  # the probe succeeded
        out.append(status(driver))
    # cleared long enough ago (past quarantine_max_s): back to base
    time.sleep(0.35)
    driver._quarantine_kind("K8sNeedOwner", "audit-eval", RuntimeError("x"))
    out.append(status(driver))
    return out


def _unsanctioned_success(driver):
    driver.quarantine_base_s = 30.0
    driver._quarantine_kind("K8sNeedOwner", "audit-eval", RuntimeError("x"))
    # an eval already in flight when the kind was quarantined succeeds:
    # no probe lease, so the breaker stays open
    driver._quarantine_clear("K8sNeedOwner")
    return [status(driver), driver._quarantined("K8sNeedOwner")]


@pytest.mark.parametrize("case, want", [
    (_lease_expiry, [False, True, False, True, {"K8sNeedOwner": 1}]),
    (_backoff_resumes, [{"K8sNeedOwner": 1}, False, {},
                        {"K8sNeedOwner": 2}, False, {},
                        {"K8sNeedOwner": 1}]),
    (_unsanctioned_success, [{"K8sNeedOwner": 1}, True]),
], ids=["lease-expiry", "backoff-resumes", "unsanctioned-success"])
def test_breaker_state_machine(case, want):
    """The breaker's timing rules, scripted through both drivers: the
    probe lease's expiry, the backoff history resuming inside
    quarantine_max_s (and restarting past it), and a success without a
    lease leaving the breaker open."""
    got = [case(policy_client(side)[0]) for side in SIDES]
    assert got[0] == got[1] == want


def test_one_bad_template_does_not_take_down_cobatched_reviews():
    """tests/test_resilience.py's test of the same name through both
    packages: the faulted kind from the interpreter, the healthy kind on
    the device, every review with both verdicts."""
    outs = []
    for side in SIDES:
        driver, _client = policy_client(side, team=True)
        driver.quarantine_base_s = 30.0
        pin_device(driver)
        side[4].inject("eval.device", match={"kind": "K8sNeedOwner"})
        reviews = [pod_review(f"p{i}") for i in range(8)]
        res = driver.review_batch(TARGET, reviews)
        assert len(res) == 8
        for per_review in res:
            assert sorted(r.constraint["kind"] for r in per_review) == \
                ["K8sNeedOwner", "K8sNeedTeam"]
        outs.append(([key(r) for r in res], status(driver)))
    assert outs[0] == outs[1]
    assert outs[1][1] == {"K8sNeedOwner": 1}
    # the port's own paths, as the reference's quarantine implies
    assert evals(driver) == {("K8sNeedOwner", "interp"): 1,
                             ("K8sNeedTeam", "device"): 1}


# ---------------------------------------------------- join quarantine


def _join_clients(side, objs):
    _tag, backend, target, make, _faults, pol = side
    drv = make()
    if isinstance(drv, TpuDriver):
        drv._mesh = None
    client = backend(drv).new_client([target()])
    for name, kind in sorted(JOINS.items()):
        client.add_template(pol.load(name))
        client.add_constraint(constraint(kind, kind.lower()))
    for o in objs:
        client.add_data(o)
    return drv, client


@pytest.mark.parametrize("entry", ["audit", "review_batch"])
def test_join_eval_failure_quarantines_and_interp_serves(monkeypatch,
                                                         entry):
    """A join evaluation that raises (at the join runtime's fires, the
    seam both packages share) quarantines that join kind in the audit and
    in review_batch alike; the interpreter serves it, and the other join
    kind stays on its join path. Then the fault clears: the port's probe
    restores the join path; TpuDriver's cannot run (module docstring)."""
    bad = "K8sUniqueIngressHost"
    armed = [True]
    for mod in (jjoin, tjoin):
        real = mod.JoinCompiled.fires

        def fires(self, *a, _real=real, **k):
            if armed[0] and self.kind == bad:
                raise RuntimeError("join membership kernel failed")
            return _real(self, *a, **k)

        monkeypatch.setattr(mod.JoinCompiled, "fires", fires)
    objs = with_duplicates(fixture_objects(160))
    batch = objs[-40:]
    outs, drivers = [], []
    for side in SIDES:
        drv, client = _join_clients(side, objs)
        drv.quarantine_base_s = 0.2
        if entry == "audit":
            got = key(client.audit().results())
        else:
            got = [key(r.results()) for r in client.review_batch(batch)]
        outs.append((got, status(drv),
                     evals(drv) if entry == "audit" else None))
        drivers.append((drv, client))
    assert outs[0] == outs[1]
    assert outs[1][1] == {bad: 1}
    assert any(outs[1][0])
    if entry == "audit":
        assert outs[1][2] == {(bad, "join"): 1, (bad, "interp"): 1,
                              ("K8sUniqueServiceSelector", "join"): 1}
    armed[0] = False
    time.sleep(0.25)
    again = []
    for drv, client in drivers:
        if entry == "audit":
            again.append(key(client.audit().results()))
        else:
            again.append([key(r.results())
                          for r in client.review_batch(batch)])
    assert again[0] == again[1] == outs[1][0]
    (jd, _jc), (td, _tc) = drivers
    assert td.quarantine_status() == {}
    assert status(jd) == {bad: 1}  # no probe ran (module docstring)
    if entry == "audit":
        assert td.eval_counts()[(bad, "join")] == 2


# ------------------------------------------------ failure at consume


def test_failure_at_consume_quarantines(monkeypatch):
    """A kernel's failure that surfaces at the sync (the dispatch handle's
    pairs(), where a CUDA error of K2 or K1 shows) quarantines the kind
    in _audit_consume, and the interpreter serves its results."""
    for mod in (jeval, teval):
        real = mod._EagerPairs.pairs

        def pairs(self, _real=real):
            if self._ct.kind == "K8sNeedOwner":
                raise RuntimeError("device sync failed")
            yield from _real(self)

        monkeypatch.setattr(mod._EagerPairs, "pairs", pairs)
    outs = []
    for side in SIDES:
        driver, client = policy_client(side, team=True)
        for o in namespaces(6):
            client.add_data(o)
        pin_device(driver)
        res = key(client.audit().results())
        outs.append((res, status(driver), evals(driver)))
    assert outs[0] == outs[1]
    res, q, counts = outs[1]
    assert len(res) == 12 and q == {"K8sNeedOwner": 1}
    assert counts == {("K8sNeedOwner", "device"): 1,
                      ("K8sNeedOwner", "interp"): 1,
                      ("K8sNeedTeam", "device"): 1}


# ------------------------------------------------------- async warm-up


def _warm_client(side, n=600):
    """tests/test_ir_regressions.py's async-warm setup: requiredlabels,
    one constraint, n Namespaces, every other one labelled."""
    _tag, backend, target, make, _faults, pol = side
    drv = make()
    if isinstance(drv, TpuDriver):
        drv._mesh = None
    drv.async_warm = True
    drv._dev_batch_lat_s = 1e-4  # the cost model would pick the device
    client = backend(drv).new_client([target()])
    client.add_template(pol.load("general/requiredlabels"))
    client.add_constraint(constraint("K8sRequiredLabels", "owner",
                                     {"labels": [{"key": "owner"}]}))
    for i in range(n):
        o = {"apiVersion": "v1", "kind": "Namespace",
             "metadata": {"name": f"ns{i:04d}"}}
        if i % 2 == 0:
            o["metadata"]["labels"] = {"owner": "me"}
        client.add_data(o)
    return drv, client


def test_async_warm_serves_host_then_hot_swaps():
    """tests/test_ir_regressions.py's test of the same name through both
    packages: the first audit at a new sweep shape returns exact results
    from the host path while the device sweep warms in the background;
    once warm, the same audit takes the device and agrees exactly."""
    runs = []
    for side in SIDES:
        drv, client = _warm_client(side)
        got1 = sorted(key(client.audit().results()))
        st = drv.warm_status()
        assert st["warm"] + st["compiling"] >= 1, "no warm-up was started"
        wait_warm(drv)
        assert drv.warm_status()["warm"] >= 1, "device program never warmed"
        # the results delta cache would answer this unchanged re-audit
        # without dispatching; drop it to reach the post-warm sweep
        drv._audit_results_cache.clear()
        got2 = sorted(key(client.audit().results()))
        # non-vacuous: the device consume path updates the latency EMA
        assert drv._dev_batch_lat_s != 1e-4, "post-warm audit stayed on host"
        runs.append((got1, got2, evals(drv)))
    assert runs[0] == runs[1]
    got1, got2, counts = runs[1]
    assert got1 == got2 and len(got1) == 300
    assert counts == {("K8sRequiredLabels", "interp"): 1,
                      ("K8sRequiredLabels", "device"): 1}


def test_warm_gate_blocks_when_host_estimate_exceeds_limit():
    """Block-when-cheaper: when the host would take more than
    ASYNC_WARM_MAX_HOST_S (here 300 masked pairs at 1 pair/s), the first
    audit waits the warm out and takes the device."""
    runs = []
    for side in SIDES:
        drv, client = _warm_client(side)
        drv._host_pair_rate = 1.0
        res = sorted(key(client.audit().results()))
        runs.append((res, evals(drv), drv.warm_status()["warm"],
                     drv.warm_status()["compiling"]))
    assert runs[0] == runs[1]
    res, counts, warm, compiling = runs[1]
    assert len(res) == 300 and (warm, compiling) == (1, 0)
    assert counts == {("K8sRequiredLabels", "device"): 1}


@pytest.mark.parametrize("branch, rate, first_path", [
    ("dense", 1.0, "interp"),
    ("sparse", 100.0, "interp"),
    ("sparse", 1.0, "device"),
], ids=["dense-serves-host", "sparse-serves-host", "sparse-blocks"])
def test_review_batch_warm_gate(branch, rate, first_path):
    """A review batch at a cold shape: the dense branch always serves the
    host this round (_ServeHostThisRound) while the shape warms; the
    sparse branch serves the host (27 masked pairs at 100 pairs/s) or,
    past ASYNC_WARM_MAX_HOST_S (at 1 pair/s), waits the warm out. After
    the warm, the same batch takes the device. Both batches equal
    TpuDriver's, and TpuDriver's warm counts equal."""
    objs = [{"apiVersion": "v1", "kind": "Namespace",
             "metadata": {"name": f"ns{i}", **(
                 {"labels": {"owner": "me"}} if i % 3 else {})}}
            for i in range(40)]
    runs = []
    for side in SIDES:
        drv, client = _warm_client(side, n=0)
        if branch == "sparse":
            drv.SPARSE_BATCH_MIN = 8
        drv._host_pair_rate = rate
        first = [key(r.results()) for r in client.review_batch(objs)]
        wait_warm(drv)
        drv._dev_batch_lat_s = 1e-4
        drv._host_pair_rate = rate
        second = [key(r.results()) for r in client.review_batch(objs)]
        runs.append((first, second, drv.warm_status()["warm"]))
    assert runs[0] == runs[1]
    assert runs[1][0] == runs[1][1] and runs[1][2] == 1
    counts = evals(drv)
    if first_path == "device":
        assert counts == {("K8sRequiredLabels", "device"): 2}
    else:
        assert counts == {("K8sRequiredLabels", "interp"): 1,
                          ("K8sRequiredLabels", "device"): 1}


NEED_APP = """
package k8sneedapp
violation[{"msg": "no app label"}] {
  not input.review.object.metadata.labels.app
}
"""


@pytest.mark.parametrize("entry", ["audit", "review_batch"])
def test_warm_gate_budget_is_per_call(entry):
    """The cold kinds of one audit or review batch share the host budget
    (ASYNC_WARM_MAX_HOST_S, here 0.3 s): each kind's estimate alone is
    nil, but once the host seconds measured on the cold kinds served so
    far pass it, the next cold kind waits its warm out and takes the
    device. Every kind's results equal the interpreter's. TpuDriver
    weighs each kind alone and would serve all three from the host (the
    port's deliberate difference)."""
    kinds = (("K8sNeedApp", NEED_APP), ("K8sNeedOwner", NEED_OWNER),
             ("K8sNeedTeam", NEED_TEAM))
    objs = namespaces(20)
    got = {}
    for make in (lambda: TorchDriver(device="cpu"), TRegoDriver):
        drv = make()
        client = TBackend(drv).new_client([TTarget()])
        for kind, rego in kinds:
            client.add_template(template(kind, rego))
            client.add_constraint(constraint(kind, kind.lower()))
        if isinstance(drv, TorchDriver):
            drv.async_warm = True
            drv.ASYNC_WARM_MAX_HOST_S = 0.3
            drv._host_pair_rate = 1e9
            drv._use_device_for_batch = lambda n: True
            drv.SPARSE_BATCH_MIN = 8
            host = drv._eval_template_violations

            def slow(*a, **k):
                time.sleep(0.2 / len(objs))  # 0.2 s a kind on the host
                return host(*a, **k)

            drv._eval_template_violations = slow
        if entry == "audit":
            for o in objs:
                client.add_data(o)
            got[make] = sorted(key(client.audit().results()))
        else:
            got[make] = [sorted(key(r.results()))
                         for r in client.review_batch(objs)]
        if isinstance(drv, TorchDriver):
            wait_warm(drv)
            counts = evals(drv)
    port, interp = got.values()
    assert port == interp
    assert (len(port) if entry == "audit" else sum(map(len, port))) == 60
    assert counts == {("K8sNeedApp", "interp"): 1,
                      ("K8sNeedOwner", "interp"): 1,
                      ("K8sNeedTeam", "device"): 1}


def test_warm_that_fails_twice_is_marked_warm_then_quarantines():
    """A background warm that fails is retried once; after the second
    failure its shape is marked warm, so that the next audit dispatches
    in the foreground, where the failure quarantines the kind."""
    runs = []
    for side in SIDES:
        drv, client = _warm_client(side)

        def broken(*a, **k):
            raise RuntimeError("kernel launch failed")

        drv._dispatch_handle = broken
        out = []
        for _ in range(3):
            drv._audit_results_cache.clear()
            out.append(sorted(key(client.audit().results())))
            wait_warm(drv)
            out.append((dict(drv.warm_status(), aot=None),
                        sorted(drv._warm_fail.values()), status(drv)))
        runs.append((out, evals(drv)))
    assert runs[0] == runs[1]
    out, counts = runs[1]
    assert out[0] == out[2] == out[4] and len(out[0]) == 300
    assert [o[1:] for o in out[1::2]] == [
        ([1], {}), ([2], {}), ([], {"K8sRequiredLabels": 1})]
    assert counts == {("K8sRequiredLabels", "interp"): 3}


@pytest.mark.parametrize("change", ["update", "delete"])
def test_template_change_drops_warm(change):
    """_drop_warm: a template update or delete forgets the kind's warm
    shapes (a fresh CompiledTemplate has an empty kernel cache), so the
    next audit at the same shape serves the host and warms again."""
    runs = []
    for side in SIDES:
        drv, client = _warm_client(side, n=40)
        client.audit()
        wait_warm(drv)
        out = [drv.warm_status()["warm"]]
        tmpl = side[5].load("general/requiredlabels")
        if change == "update":
            # a new generation of the template (the same program)
            for t in tmpl["spec"]["targets"]:
                t["rego"] += "\n# generation 2\n"
            client.add_template(tmpl)
        else:
            client.remove_template(tmpl)
        out.append(drv.warm_status()["warm"])
        if change == "delete":
            client.add_template(tmpl)
            client.add_constraint(constraint(
                "K8sRequiredLabels", "owner",
                {"labels": [{"key": "owner"}]}))
        drv._dev_batch_lat_s = 1e-4
        res = sorted(key(client.audit().results()))
        wait_warm(drv)
        out += [drv.warm_status()["warm"], len(res)]
        runs.append((out, evals(drv)))
    assert runs[0] == runs[1]
    assert runs[1][0] == [1, 0, 1, 20]
    assert runs[1][1] == {("K8sRequiredLabels", "interp"): 2}


# ---------------------------------------------------- compile counting


@pytest.mark.parametrize("where", ["this-thread", "other-thread"])
def test_compile_count_is_per_thread(monkeypatch, where):
    """kernels/build.py counts compiles per thread beside the global
    count: a sample of the dense branch is dropped when its own thread
    compiled during it, and kept when another thread (the warm) did."""
    td = TorchDriver(device="cpu")
    client = TBackend(td).new_client([TTarget()])
    client.add_template(tpol.load("general/requiredlabels"))
    client.add_constraint(constraint("K8sRequiredLabels", "owner",
                                     {"labels": [{"key": "owner"}]}))
    td._use_device_for_batch = lambda n: True
    orig = td._eval_compiled_gated

    def compiling(*a, **k):
        if where == "this-thread":
            kernel_build.note_compiles(1)
        else:
            t = threading.Thread(target=kernel_build.note_compiles,
                                 args=(1,))
            t.start()
            t.join()
        return orig(*a, **k)

    monkeypatch.setattr(td, "_eval_compiled_gated", compiling)
    total, mine = kernel_build.compiles, kernel_build.thread_compiles()
    client.review_batch([{"apiVersion": "v1", "kind": "Namespace",
                          "metadata": {"name": f"n{i}"}} for i in range(8)])
    assert kernel_build.compiles == total + 1
    assert kernel_build.thread_compiles() == mine + (where == "this-thread")
    assert td.eval_counts() == {("K8sRequiredLabels", "device"): 1}
    assert (td._dev_batch_lat_s is None) == (where == "this-thread")


@pytest.mark.parametrize("n, n_true, slab, dense", [
    (20, 20, 4096, False),   # one launch over every row
    (20, 20, 8, False),      # slabs of 8, the last clamped to a full one
    (20, 9, 8, False),       # padding rows past n_true: still slabbed
    (20, 8, 8, False),       # n_true == slab: one launch
    (20, 20, None, True),    # the dense batch sweep
], ids=["whole", "slabs", "slabs-padded", "n-true-at-slab", "dense"])
def test_sweep_key_names_the_launched_variants(monkeypatch, n, n_true, slab,
                                               dense):
    """CompiledTemplate.sweep_key is the warm state's key: it must name
    exactly the K2 variants (clause_triton.variant_key: the kernel and
    the rows of each launch) that the sweep launches, through
    fires_pairs_dispatch's slab rule or the dense fires_chunked."""
    from gatekeeper_tpu_torch.kernels.clause import feat_rows
    from gatekeeper_tpu_torch.kernels.clause_triton import variant_key

    drv, client = _warm_client(SIDES[1], n=n)
    kind = "K8sRequiredLabels"
    ct = drv.compiled_for(kind)
    reviews = drv._inventory_reviews(TARGET)
    cons = drv._constraints(TARGET)
    feats, enc, table, derived = drv._prepare_eval(ct, kind, reviews, cons,
                                                   None)
    seen = set()
    words = teval.CompiledTemplate.words

    def recorded(self, f, p, t, d, *a, **k):
        seen.add(variant_key(f, p, t, d or {}, feat_rows(f)))
        return words(self, f, p, t, d, *a, **k)

    monkeypatch.setattr(teval.CompiledTemplate, "words", recorded)
    if dense:
        ct.fires_chunked(feats, enc, table, derived, chunk=8)
    else:
        for _ in ct.fires_pairs_dispatch(feats, enc, table, derived,
                                         chunk=8, slab=slab,
                                         n_true=n_true).pairs():
            pass
    assert seen == {ct.sweep_key(feats, enc, table, derived, slab=slab,
                                 n_true=n_true)}


class _FakeKernel:
    """A stand-in of a Triton JIT function: `kernel[grid](key, compile_s)`
    compiles (sleeps `compile_s` seconds or waits for it, an Event, then
    caches) a variant it has not seen, and returns its compiled kernel."""

    def __init__(self):
        self.device_caches = {0: ({},)}

    def __getitem__(self, grid):
        def run(key, compile_s=0.0):
            cache = self.device_caches[0][0]
            if key not in cache:
                if isinstance(compile_s, threading.Event):
                    compile_s.wait(10)
                else:
                    time.sleep(compile_s)
                cache[key] = [grid]  # a new compiled kernel
            return cache[key]
        return run


@pytest.mark.parametrize("other", ["compiling", "idle"])
def test_launch_waiting_on_another_threads_compile_drops_sample(other):
    """A K2 launch of a variant not launched before holds its kernel's
    lock (Triton's cache of a JIT function is not safe to grow from two
    threads). A serving launch that waits there while the warm thread
    compiles the same variant compiles nothing itself, and drops its
    latency sample: the wait is noted on the serving thread, so
    _observe_latency finds its stamp moved. With the lock free, a launch
    of a launched variant keeps its sample."""
    from gatekeeper_tpu_torch.kernels import clause_triton

    td = TorchDriver(device="cpu")
    ent = clause_triton._Entry(_FakeKernel(), "", (1, 1, 1, 1), 0)
    clause_triton._run(ent, (1,), "warm", variant="warm")
    serving, warm = "warm", None
    if other == "compiling":
        serving = "new"
        warm = threading.Thread(
            target=clause_triton._run, args=(ent, (2,), "new"),
            kwargs={"compile_s": 0.3, "variant": "new"})
        warm.start()
        wait_for(ent.lock.locked)
    total, mine = kernel_build.compiles, kernel_build.thread_compiles()
    t0, stamp = time.monotonic(), kernel_build.thread_stamp()
    clause_triton._run(ent, (1,), serving, variant=serving)
    sample = td._observe_latency(t0, stamp)
    if warm is not None:
        warm.join(10)
    assert kernel_build.thread_compiles() == mine  # waited, not compiled
    if other == "compiling":
        assert sample is None and td._dev_batch_lat_s is None
        assert kernel_build.compiles == total + 1  # the warm thread's
    else:
        assert sample is not None and td._dev_batch_lat_s == sample
        assert kernel_build.compiles == total


def test_launched_variant_does_not_wait_out_another_variants_compile():
    """A launch of a variant its kernel has launched before takes no
    lock: while the warm thread compiles another variant of the same
    kernel (holding the lock), the serving launch returns at once,
    compiles nothing, notes no wait and keeps its latency sample. A
    launch that finds its compiled kernel gone from Triton's cache (a
    compile again) counts it."""
    from gatekeeper_tpu_torch.kernels import clause_triton

    td = TorchDriver(device="cpu")
    ent = clause_triton._Entry(_FakeKernel(), "", (1, 1, 1, 1), 0)
    clause_triton._run(ent, (1,), "warm", variant="warm")
    release = threading.Event()
    warm = threading.Thread(
        target=clause_triton._run, args=(ent, (2,), "new"),
        kwargs={"compile_s": release, "variant": "new"})
    warm.start()
    try:
        wait_for(ent.lock.locked)
        total, mine = kernel_build.compiles, kernel_build.thread_compiles()
        t0, stamp = time.monotonic(), kernel_build.thread_stamp()
        clause_triton._run(ent, (1,), "warm", variant="warm")
        assert ent.lock.locked(), "the compile was still under way"
        sample = td._observe_latency(t0, stamp)
        assert sample is not None and td._dev_batch_lat_s == sample
        assert kernel_build.thread_stamp() == stamp
        assert kernel_build.compiles == total
        assert kernel_build.thread_compiles() == mine
        assert ("warm", ()) in clause_triton._launched(ent.kernel)
    finally:
        release.set()
        warm.join(10)
    assert not warm.is_alive()
    assert ("new", ()) in clause_triton._launched(ent.kernel)
    assert kernel_build.compiles == total + 1  # the warm thread's
    ent.kernel.device_caches[0][0].clear()
    clause_triton._run(ent, (1,), "warm", variant="warm")
    assert kernel_build.compiles == total + 2
    assert kernel_build.thread_compiles() == mine + 1


def test_unlocked_launch_inside_a_compile_keeps_its_variant(monkeypatch):
    """A compiling launch keeps its own compiled kernel: a launch of
    another, already launched variant that runs (without the lock)
    between the compile and its record must not map the compiling
    variant's key to the other variant's kernel. Here the unlocked
    launch of "warm" runs on a second thread while "new"'s compile
    counts its compiles; afterwards "new" maps to its own kernel, and a
    further launch of "new" counts no compile."""
    from gatekeeper_tpu_torch.kernels import clause_triton

    ent = clause_triton._Entry(_FakeKernel(), "", (1, 1, 1, 1), 0)
    clause_triton._run(ent, (1,), "warm", variant="warm")
    note = kernel_build.note_compiles
    compiling = threading.current_thread()
    interleaved = []

    def interleaving(n):
        if threading.current_thread() is compiling and not interleaved:
            other = threading.Thread(
                target=clause_triton._run, args=(ent, (1,), "warm"),
                kwargs={"variant": "warm"})
            other.start()
            other.join(10)
            interleaved.append(not other.is_alive())
        return note(n)

    monkeypatch.setattr(kernel_build, "note_compiles", interleaving)
    clause_triton._run(ent, (2,), "new", variant="new")
    assert interleaved == [True]
    cache = ent.kernel.device_caches[0][0]
    launched = clause_triton._launched(ent.kernel)
    assert launched[("new", ())] is cache["new"]
    assert launched[("warm", ())] is cache["warm"]
    total, mine = kernel_build.compiles, kernel_build.thread_compiles()
    clause_triton._run(ent, (2,), "new", variant="new")
    assert kernel_build.compiles == total
    assert kernel_build.thread_compiles() == mine


def test_counters_and_warm_under_threads():
    """The port's first threads: a lost update on the shared counters or
    the warm sets would show here. 32 threads (more than the cores) with
    a shortened switch interval bump one wrapper's launch count and the
    compile counts, and race _spawn_warm on one signature: every launch
    and compile is counted once, each thread sees only its own compiles,
    and the signature warms exactly once."""
    import sys

    def wrapper():
        pass

    wrapper.launches = 0
    N = 3000
    td = TorchDriver(device="cpu")
    runs = []
    gate = threading.Event()
    total0 = kernel_build.compiles
    seen = {}

    def work(i):
        gate.wait(10)
        mine = kernel_build.thread_compiles()
        for _ in range(N):
            kernel_build.count_launch(wrapper)
        for _ in range(N):
            kernel_build.note_compiles(1)
        seen[i] = kernel_build.thread_compiles() - mine
        td._spawn_warm(("K", 1), "K", lambda: runs.append(1))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        gate.set()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    wait_warm(td, timeout=30)
    assert wrapper.launches == 32 * N
    assert kernel_build.compiles - total0 == 32 * N
    assert seen == {i: N for i in range(32)}
    assert runs == [1]
    st = td.warm_status()
    assert (st["warm"], st["compiling"]) == (1, 0)


def test_dense_batch_at_a_warm_shape_takes_the_device_while_its_kind_warms():
    """With async warm on, a dense review batch at a warm shape runs on
    the device while another shape of the same kind is warming, as in
    the JAX package: only the cold shape itself serves the host (a K2
    launch of a launched variant waits for no other variant's compile,
    test_launched_variant_does_not_wait_out_another_variants_compile).
    Results are the interpreter's throughout."""
    side = SIDES[1]
    drv, client = _warm_client(side, n=0)
    drv._use_device_for_batch = lambda n: True
    objs = namespaces(8)
    want = [key(r.results()) for r in client.review_batch(objs)]
    wait_warm(drv)
    assert [key(r.results()) for r in client.review_batch(objs)] == want
    assert evals(drv) == {("K8sRequiredLabels", "interp"): 1,
                          ("K8sRequiredLabels", "device"): 1}
    release = threading.Event()
    drv._spawn_warm(("dense", "K8sRequiredLabels", "held"),
                    "K8sRequiredLabels", lambda: release.wait(10))
    try:
        assert [key(r.results()) for r in client.review_batch(objs)] == want
        assert evals(drv) == {("K8sRequiredLabels", "interp"): 1,
                              ("K8sRequiredLabels", "device"): 2}
        assert drv.warm_status()["compiling"] == 1
    finally:
        release.set()
    wait_warm(drv)
