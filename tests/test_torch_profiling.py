"""The port's profiler (utils/profiling.py) against the JAX package's.

The phases an audit records into profiling.timers() at the reference's
sites (delta_serve, encode, device_sweep, materialize, interp_eval; and
compile, which neither package records here: no K2 variant compiles on
the CPU, and the JAX package times only compiles its program store
acquires) must be the same in both packages for the general library's
first audit, its steady audit and an audit after churn, as the cost
model decides and with the device path pinned; the seconds differ.
compiled_hlo renders K2's generated Triton source where the JAX package
renders its lowered program, and device_trace writes a torch.profiler
Chrome trace where the JAX package writes a jax.profiler one.
"""

from __future__ import annotations

import copy
import importlib
import json
import os

import pytest

from gatekeeper_tpu import policies as jpol
from gatekeeper_tpu.client import Backend as JBackend
from gatekeeper_tpu.ir import TpuDriver
from gatekeeper_tpu.target import K8sValidationTarget as JTarget
from gatekeeper_tpu.utils import profiling as jprofiling
from gatekeeper_tpu_torch import policies as tpol
from gatekeeper_tpu_torch.client import Backend as TBackend
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.kernels import clause_triton
from gatekeeper_tpu_torch.parallel.workload import (
    GENERAL_CONSTRAINTS,
    synth_mixed_objects,
)
from gatekeeper_tpu_torch.target import K8sValidationTarget as TTarget
from gatekeeper_tpu_torch.utils import profiling as tprofiling

TARGET = "admission.k8s.gatekeeper.sh"
N_OBJECTS = 400


def general_client(backend, target, pol, drv):
    """The general library (its 7 templates, GENERAL_CONSTRAINTS) over
    N_OBJECTS synth_mixed_objects, as BENCH config 2 loads it."""
    client = backend(drv).new_client([target()])
    for name in pol.names():
        if name.startswith("general/"):
            client.add_template(pol.load(name))
    for kind, cname, params in GENERAL_CONSTRAINTS:
        client.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind, "metadata": {"name": cname},
            "spec": ({"parameters": params} if params else {})})
    for o in synth_mixed_objects(N_OBJECTS, seed=2):
        client.add_data(o)
    return client


def churned(objs: list, round_: int) -> list:
    """Every 25th object with a churned label, every 50th also given a
    container image no allowed repo matches."""
    out = []
    for i in range(0, len(objs), 25):
        o = copy.deepcopy(objs[i])
        o["metadata"].setdefault("labels", {})["churn"] = f"r{round_}"
        spec = o.get("spec", {})
        spec = spec.get("template", {}).get("spec", spec)
        if i % 50 == 0 and spec.get("containers"):
            spec["containers"][0]["image"] = "docker.io/churned:1"
        out.append(o)
    return out


def phase_names(profiling, client, objs) -> list:
    """Per audit (first, steady, after churn): the results' count, the
    driver's path and the phases profiling.timers() recorded."""
    timers = profiling.timers()
    out = []
    for step in ("first", "steady", "churn"):
        if step == "churn":
            for o in churned(objs, 1):
                client.add_data(o)
        before = timers.snapshot()
        n = len(client.audit().results())
        names = sorted(profiling.PhaseTimers.diff(before, timers.snapshot()))
        out.append((step, n, names))
    return out


@pytest.mark.parametrize("mode", ["cost model", "pinned"])
def test_audit_phase_names_equal_tpu_driver(mode):
    objs = synth_mixed_objects(N_OBJECTS, seed=2)
    got = {}
    for name, backend, target, pol, drv, prof in (
            ("jax", JBackend, JTarget, jpol, TpuDriver(), jprofiling),
            ("torch", TBackend, TTarget, tpol, TorchDriver(device="cpu"),
             tprofiling)):
        if mode == "pinned":
            drv._use_device_for_batch = lambda n: True
        client = general_client(backend, target, pol, drv)
        got[name] = phase_names(prof, client, objs)
    assert got["torch"] == got["jax"]
    names = {n for _s, _n, ns in got["torch"] for n in ns}
    assert "compile" not in names
    if mode == "pinned":
        # the device path's phases, and the delta cache's
        assert {"encode", "device_sweep", "materialize",
                "delta_serve"} <= names
    else:
        assert "interp_eval" in names


def test_consume_splits_device_wait_from_materialize(monkeypatch):
    """_audit_consume times the wait for each slab's pairs (the sync and
    copy to the host, inside the handle's pairs()) as device_sweep and
    the host's work on them as materialize, as the reference does."""
    import time

    from gatekeeper_tpu_torch.ir import driver as tdriver

    drv = TorchDriver(device="cpu")
    drv._use_device_for_batch = lambda n: True
    client = general_client(TBackend, TTarget, tpol, drv)
    pairs = tdriver.TorchDriver._dispatch_handle

    def slow_handle(self, *a, **k):
        h = pairs(self, *a, **k)
        inner = h.pairs

        def waited():
            for item in inner():
                time.sleep(0.02)  # a device wait
                yield item
        h.pairs = waited
        return h

    materialize = tdriver.TorchDriver.materialize_pairs

    def slow_materialize(self, *a, **k):
        time.sleep(0.01)
        return materialize(self, *a, **k)

    monkeypatch.setattr(tdriver.TorchDriver, "_dispatch_handle", slow_handle)
    monkeypatch.setattr(tdriver.TorchDriver, "materialize_pairs",
                        slow_materialize)
    timers = tprofiling.timers()
    before = timers.snapshot()
    busy0 = drv._busy_s
    client.audit()
    diff = tprofiling.PhaseTimers.diff(before, timers.snapshot())
    n_kinds = drv.eval_counts()
    dev_kinds = sum(1 for (k, p), c in n_kinds.items() if p == "device")
    assert dev_kinds >= 3
    assert diff["device_sweep"] >= 0.02 * dev_kinds
    assert diff["materialize"] >= 0.01 * dev_kinds
    # note_busy keeps the whole consume
    assert drv._busy_s - busy0 >= diff["device_sweep"] + diff["materialize"]


def test_compiled_hlo_renders_k2_source():
    """compiled_hlo's "jaxpr" and "hlo" stages render K2's generated
    Triton source for the template's sweep inputs; "optimized" (PTX)
    needs the card. templates_debug's hlo_dump names it."""
    drv = TorchDriver(device="cpu")
    drv._use_device_for_batch = lambda n: True
    client = general_client(TBackend, TTarget, tpol, drv)
    client.audit()
    kind = "K8sContainerLimits"
    ct = drv.compiled_for(kind)
    reviews = drv._inventory_reviews(TARGET)
    cons = drv._constraints(TARGET)
    cons = [c for c in cons if c["kind"] == kind]
    feats, enc, table, derived = drv._prepare_eval(ct, kind, reviews, cons,
                                                   None)
    src = clause_triton.generate(ct.plans, feats, enc, table, derived)[0]
    for stage in ("jaxpr", "hlo"):
        assert tprofiling.compiled_hlo(ct, feats, enc, table, derived,
                                       stage=stage) == src
    assert "def clause_kernel(" in src and "@triton.jit" in src
    with pytest.raises(ValueError, match="on the card"):
        tprofiling.compiled_hlo(ct, feats, enc, table, derived,
                                stage="optimized")
    dump = drv.templates_debug()["templates"][kind]["hlo_dump"]
    path = dump.split("(", 1)[0]
    mod, fn = path.rsplit(".", 1)
    assert getattr(importlib.import_module(mod), fn) is \
        tprofiling.compiled_hlo


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """device_trace writes torch.profiler's Chrome trace of the block
    into log_dir (the CPU's activity here; the card's kernels with it
    on a card) and yields the profiler."""
    import torch

    d = tmp_path / "trace"
    with tprofiling.device_trace(str(d)) as prof:
        torch.ones(64).cumsum(0)
    files = [f for f in os.listdir(d) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(d / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in (e.get("name") or "") for e in events)
    assert any("cumsum" in a.key for a in prof.key_averages())


def test_phase_timers_match_reference():
    """PhaseTimers is the JAX package's: the same totals, counts and
    diffs from the same calls."""
    out = []
    for prof in (tprofiling, jprofiling):
        t = prof.PhaseTimers()
        s0 = t.snapshot()
        t.add("encode", 0.5)
        t.add("encode", 0.25, n=3)
        t.add("device_sweep", 1e-12)
        with t.phase("materialize"):
            pass
        s1 = t.snapshot()
        out.append((t.totals["encode"], t.counts["encode"],
                    sorted(prof.PhaseTimers.diff(s0, s1)),
                    sorted(s1)))
    assert out[0] == out[1]
    assert tprofiling.timers() is tprofiling.timers()


def test_k2_compile_is_timed_as_compile():
    """A K2 launch that compiled (grew its JIT function's cache) adds its
    seconds to the "compile" phase; a launch of a launched variant adds
    nothing. A stand-in of Triton's JIT function compiles here."""
    from .test_torch_lifecycle import _FakeKernel

    ent = clause_triton._Entry(_FakeKernel(), "", (1, 1, 1, 1), 0)
    timers = tprofiling.timers()
    before = timers.snapshot()
    clause_triton._run(ent, (1,), "v", 0.05, variant="v")
    mid = timers.snapshot()
    clause_triton._run(ent, (1,), "v", 0.05, variant="v")
    after = timers.snapshot()
    assert tprofiling.PhaseTimers.diff(before, mid)["compile"] >= 0.05
    assert mid["compile"][1] == before.get("compile", (0.0, 0))[1] + 1
    assert tprofiling.PhaseTimers.diff(mid, after) == {}
