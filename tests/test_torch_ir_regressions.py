"""The JAX package's compiler and driver regressions on the port
(tests/test_ir_regressions.py, case for case).

Each case feeds the same template, constraints and objects to the port's
RegoDriver, TorchDriver on the CPU and the JAX package's TpuDriver, the
compiled drivers both as the cost model decides (the reference's setting)
and pinned to the device path: duplicate-sensitive counts, the count of a
set comprehension, bare scalar guards, large-integer equality (2^24 + 1),
trim cutsets, computed-key brackets and parameterless programs; then
autoreject, the parameter cache across a template update, demotion,
pairs against dense verdicts with padding and a forced re-gather, the
vocabulary's growth across audits and the async warm's hot swap. Results
are compared whole (the reference's result_key) and by the reference's
own expected names; tolerance: exact. The pinned drivers' eval-path
counters must show the device path served.
"""

from __future__ import annotations

import ast
import logging
import time
from dataclasses import replace

import numpy as np
import pytest

from gatekeeper_tpu.control.metrics import REGISTRY as JREGISTRY
from gatekeeper_tpu.ir import prog as jprog
from gatekeeper_tpu.parallel import workload as jwork
from gatekeeper_tpu_torch.control.metrics import REGISTRY as TREGISTRY
from gatekeeper_tpu_torch.ir import prog as tprog
from gatekeeper_tpu_torch.ir.carry import tree_from_numpy
from gatekeeper_tpu_torch.parallel import workload as twork

from . import test_ir_regressions as ref
from .test_torch_compile_coverage import JAX, TORCH, TRegoDriver, all_drivers
from .torch_compiler_cases import (
    AUTOREJECT_CONSTRAINT,
    AUTOREJECT_NS,
    AUTOREJECT_REGO,
    DEMOTION_REGO,
    PARAM_CACHE_OBJS,
    PARAM_CACHE_REGO_A,
    PARAM_CACHE_REGO_B,
    REGRESSIONS,
    assert_served,
    constraint,
    containerlimits_pods,
    eval_paths,
    keys,
    loaded_client,
    mk,
    names,
    warm_namespaces,
)


def _pinned(name: str) -> bool:
    return name.endswith("-pinned")


@pytest.mark.parametrize("case", sorted(REGRESSIONS))
def test_regression_case_equal(case):
    """The reference's template-shape regressions (dup_sensitive_count:
    :56, count_of_set_comprehension: :75, bare_scalar_guard: :93,
    large_integer_equality: :111, trim_empty_cutset: :230,
    trim_cutset_at_sign: :249, computed_key_bracket: :368,
    parameterless_every_constraint: :314): every driver gives the
    reference's names and the same results. The port compiles each
    kind where TpuDriver does, with the same fallback record, and the
    pinned drivers serve a compiled kind on the device path; a kind
    neither compiles (the duplicate-sensitive count: a set-derived
    count compared with 1) is served by the interpreter in both."""
    rego, cons, objs, want = REGRESSIONS[case]
    cons = [constraint("K8sTest", n, p) for n, p in cons]
    outs, compiled, reasons, drivers = {}, {}, {}, all_drivers()
    for name, (P, drv) in drivers.items():
        client = loaded_client(P.Backend, P.Target, drv, [mk(rego)], cons,
                               objs)
        res = client.audit().results()
        outs[name] = keys(res)
        if want is not None:
            assert names(res) == want, name
        if name == "rego":
            continue
        compiled[name] = drv.compiled_for("K8sTest") is not None
        reasons[name] = {k: (e["reason"], e["dense"]["code"])
                         for k, e in drv.fallback_reasons().items()}
        if _pinned(name):
            assert_served(drv, ["K8sTest"],
                          ("device",) if compiled[name] else ("interp",))
    assert all(o == outs["rego"] for o in outs.values()), outs
    assert len(set(compiled.values())) == 1, compiled
    assert all(r == reasons["tpu"] for r in reasons.values()), reasons
    assert compiled["tpu"] == (case != "dup_sensitive_count")
    if want is None:  # every (object, constraint) pair
        assert len(outs["rego"]) == len(objs) * len(cons) == 80


def test_autoreject_unions_with_matching():
    """A Namespace review: autoreject and the template's violation both
    surface on every driver path, alone (the reference's case) and as
    each of a batch of 8, which the pinned port serves on the device
    path (TpuDriver's review batch leaves its eval counters alone)."""
    want = ["Namespace is not cached in OPA.", "always"]
    for name, (P, drv) in all_drivers().items():
        client = loaded_client(P.Backend, P.Target, drv,
                               [mk(AUTOREJECT_REGO)],
                               [AUTOREJECT_CONSTRAINT], [])
        msgs = sorted(r.msg for r in client.review(
            P.Aug(AUTOREJECT_NS)).results())
        assert msgs == want, (name, msgs)
        batch = client.review_batch([P.Aug(AUTOREJECT_NS)] * 8)
        assert [sorted(r.msg for r in b.results()) for b in batch] == \
            [want] * 8, name
        if name == "torch-pinned":
            assert_served(drv, ["K8sTest"], ("device",))


def test_template_update_invalidates_param_cache():
    """A template's Rego updated under unchanged constraints re-encodes
    the parameters for the new program, in every driver."""
    for name, (P, drv) in all_drivers().items():
        client = loaded_client(
            P.Backend, P.Target, drv, [mk(PARAM_CACHE_REGO_A)],
            [constraint("K8sTest", "c", {"prefix": "evil/", "name": "p2"})],
            PARAM_CACHE_OBJS)
        assert names(client.audit().results()) == ["p1"], name
        client.add_template(mk(PARAM_CACHE_REGO_B))
        assert names(client.audit().results()) == ["p2"], name
        if _pinned(name):
            assert_served(drv, ["K8sTest"], ("device",))


def test_demotion_is_logged_and_counted(caplog):
    """A lowering failure demotes the kind with a warning naming it and
    one gatekeeper_tpu_device_demotions_total count, in the port as in
    the reference; the interpreter then audits it correctly (the eval
    counters say interp)."""
    got = {}
    for (name, P, prog, registry, logger) in (
            ("torch", TORCH, tprog, TREGISTRY, "gatekeeper_tpu_torch.ir.driver"),
            ("tpu", JAX, jprog, JREGISTRY, "gatekeeper_tpu.ir.driver")):
        drv = P.driver()
        client = loaded_client(P.Backend, P.Target, drv,
                               [mk(DEMOTION_REGO)], [], [])
        p = drv._programs["K8sTest"]
        drv._programs["K8sTest"] = replace(
            p, derived=p.derived + (prog.DerivedSpec(99, "no-such-kind",
                                                     "x"),))

        def metric() -> float:
            m = registry._metrics.get("gatekeeper_tpu_device_demotions_total")
            return sum(m.values.values()) if m else 0.0

        before = metric()
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger):
            assert drv.compiled_for("K8sTest") is None
        assert metric() == before + 1
        warned = [r.message for r in caplog.records
                  if "demoted" in r.message and "K8sTest" in r.message]
        assert warned, name
        client.add_constraint(constraint("K8sTest", "c", {"name": "p1"}))
        client.add_data({"apiVersion": "v1", "kind": "Pod",
                         "metadata": {"name": "p1", "namespace": "d"}})
        res = client.audit().results()
        assert names(res) == ["p1"]
        assert eval_paths(drv)["K8sTest"] == {"interp"}
        got[name] = (keys(res), drv.fallback_reasons().get("K8sTest"))
    assert got["torch"] == got["tpu"]


def test_fires_pairs_matches_dense_with_padding_and_regather():
    """The port's pair path (K1's plain version on the CPU) equals its
    dense verdicts and the JAX package's pairs at the reference's shape:
    3,000 objects in a 4,096 bucket (padding rows fire absence clauses
    and must be masked), 40 constraints, a capacity of 16 that forces the
    re-gather; the second call reuses the remembered capacity."""
    n, c = 3000, 40
    setup_t = twork.build_eval_setup(n, c, n_bucket=4096, violate_frac=0.3,
                                     device="cpu")
    setup_j = jwork.build_eval_setup(n, c, n_bucket=4096, violate_frac=0.3)
    ct = setup_t[1]
    feats, params, table, derived = (tree_from_numpy(x, "cpu")
                                     for x in setup_t[2:6])
    dense = ct.fires_chunked(feats, params, table, derived, chunk=1024)
    want = np.nonzero(dense[:n])
    ct._rows_cap = 16  # force at least one capacity re-gather
    rows, cols = ct.fires_pairs(feats, params, table, derived, chunk=1024,
                                n_true=n)
    assert rows.shape == want[0].shape and len(rows) > 16
    assert (rows == want[0]).all() and (cols == want[1]).all()
    assert ct._rows_cap >= len(np.unique(rows))
    rows2, cols2 = ct.fires_pairs(feats, params, table, derived, chunk=1024,
                                  n_true=n)
    assert (rows2 == rows).all() and (cols2 == cols).all()
    jct = setup_j[1]
    jrows, jcols = jct.fires_pairs(*setup_j[2:6], chunk=1024, n_true=n)
    assert (np.asarray(jrows) == rows).all()
    assert (np.asarray(jcols) == cols).all()


def test_audit_results_identical_across_drivers_after_pairs_path():
    """The flagship template over 60 synth objects (40% violating) and 10
    constraints: every driver's audit is the same, non-empty, and the
    pinned drivers take the device path."""
    objs = twork.synth_objects(60, violate_frac=0.4, seed=3)
    cons = twork.synth_constraints(10, seed=4)
    assert objs == jwork.synth_objects(60, violate_frac=0.4, seed=3)
    assert cons == jwork.synth_constraints(10, seed=4)
    outs = {}
    for name, (P, drv) in all_drivers().items():
        client = loaded_client(P.Backend, P.Target, drv,
                               [twork.REQUIRED_LABELS_TEMPLATE], cons, objs)
        outs[name] = keys(client.audit().results())
        if _pinned(name):
            assert_served(drv, ["K8sRequiredLabels"], ("device",))
    assert all(o == outs["rego"] for o in outs.values()) and outs["rego"]


def test_vocab_stabilizes_across_audits():
    """Derived columns do not intern new strings on every audit: the
    port's vocabulary stops growing as TpuDriver's does, at the same
    size, with the device path pinned (where the derived columns are
    materialized) and as decided."""
    sizes = {}
    for name, (P, drv) in all_drivers().items():
        if name == "rego":
            continue
        client = loaded_client(
            P.Backend, P.Target, drv,
            [P.pol.load("general/containerlimits")],
            [constraint("K8sContainerLimits", "cl",
                        {"cpu": "2", "memory": "1Gi"})],
            containerlimits_pods())
        sizes[name] = []
        for _ in range(4):
            drv._audit_results_cache.clear()
            client.audit()
            sizes[name].append(len(drv.strtab))
        assert sizes[name][-1] == sizes[name][-2], (name, sizes[name])
        if _pinned(name):
            assert_served(drv, ["K8sContainerLimits"], ("device",))
    assert sizes["torch"] == sizes["tpu"]
    assert sizes["torch-pinned"] == sizes["tpu-pinned"]


def test_async_warm_serves_host_then_hot_swaps():
    """With async warm on, the first audit at a new sweep shape answers
    from the host while K2 warms in the background; once warm the same
    audit runs on the device path and is equal (the latency EMA moved).
    TpuDriver does the same."""
    want = None
    for name, P in (("rego", TORCH), ("torch", TORCH), ("tpu", JAX)):
        drv = TRegoDriver() if name == "rego" else P.driver()
        if name != "rego":
            drv._mesh = None
            drv.async_warm = True
            drv._dev_batch_lat_s = 1e-4
        client = loaded_client(
            P.Backend, P.Target, drv,
            [P.pol.load("general/requiredlabels")],
            [{"apiVersion": "constraints.gatekeeper.sh/v1beta1",
              "kind": "K8sRequiredLabels", "metadata": {"name": "owner"},
              "spec": {"parameters": {"labels": [{"key": "owner"}]}}}],
            warm_namespaces())
        got1 = sorted((r.msg, r.resource["metadata"]["name"])
                      for r in client.audit().results())
        if name == "rego":
            want = got1
            assert len(want) == 300
            continue
        assert got1 == want, name
        assert eval_paths(drv)["K8sRequiredLabels"] == {"interp"}
        st = drv.warm_status()
        assert st["warm"] + st["compiling"] >= 1, "no warm-up was started"
        deadline = time.time() + 120
        while time.time() < deadline and drv.warm_status()["warm"] < 1:
            time.sleep(0.05)
        assert drv.warm_status()["warm"] >= 1, "device program never warmed"
        drv._audit_results_cache.clear()
        got2 = sorted((r.msg, r.resource["metadata"]["name"])
                      for r in client.audit().results())
        assert got2 == want, name
        assert drv._dev_batch_lat_s != 1e-4, "post-warm audit stayed on host"
        assert "device" in eval_paths(drv)["K8sRequiredLabels"]


def _literal(node):
    """The value `node` evaluates to on its own, or None where it reads a
    name of the suite."""
    try:
        return eval(compile(ast.Expression(node), "<ref>", "eval"),
                    {"range": range})
    except NameError:
        return None


def _reference_inputs(text: str, rego: str) -> dict:
    """The literals of the reference suite's test that holds `rego`: its
    constraint(...) calls' names and parameters, and every dict, list
    and comprehension it writes out."""
    for fn in ast.parse(text).body:
        if isinstance(fn, ast.FunctionDef) and \
                rego.strip() in ast.get_source_segment(text, fn):
            calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call) and
                     getattr(n.func, "id", None) == "constraint"]
            return {
                "names": [_literal(c.args[1]) for c in calls],
                "params": [_literal(c.args[2]) if len(c.args) > 2 else None
                           for c in calls],
                "values": [_literal(n) for n in ast.walk(fn)
                           if isinstance(n, (ast.Dict, ast.List,
                                             ast.ListComp))]}
    raise AssertionError(f"no reference test holds {rego!r}")


def test_case_copies_equal_reference():
    """tests/torch_compiler_cases.py's regression inputs are the
    reference suite's own: each case's Rego body is in the file's text,
    and the test that holds it gives the same constraint names and
    parameters, objects and expected names; the autoreject and
    parameter-cache inputs are those of their tests."""
    text = open(ref.__file__).read()
    for case, (rego, cons, objs, want) in REGRESSIONS.items():
        assert rego in text, case
        ref_in = _reference_inputs(text, rego)
        assert [c for c, _ in cons] == ref_in["names"], case
        assert [p for _, p in cons] == ref_in["params"], case
        assert objs in ref_in["values"], case
        assert want is None or want in ref_in["values"], (case, want)
    for rego in (AUTOREJECT_REGO, PARAM_CACHE_REGO_A, PARAM_CACHE_REGO_B,
                 DEMOTION_REGO):
        assert rego.strip() in text
    autoreject = _reference_inputs(text, AUTOREJECT_REGO)["values"]
    assert AUTOREJECT_CONSTRAINT in autoreject
    assert AUTOREJECT_NS in autoreject
    param_cache = _reference_inputs(text, PARAM_CACHE_REGO_A)["values"]
    for obj in PARAM_CACHE_OBJS:
        assert obj in param_cache, obj
