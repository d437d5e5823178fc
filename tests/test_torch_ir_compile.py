"""The JAX package's compile differentials on the port
(tests/test_ir_compile.py: the six cases that run without the upstream
library, which its conftest's `requires_reference` marks).

An uncompilable template stays on the interpreter and audits correctly;
the three float32 ties (16,777,217 against 16,777,216, plain and under
`not`) never under-fire on the device path, whose exact-id mismatch
over-fires for the host re-check to settle; compiled_hlo renders the
device program; PhaseTimers counts phases. Each driver case feeds the
same template, constraint and objects to the port's RegoDriver, TorchDriver
on the CPU and TpuDriver, as the cost model decides and pinned, audits
and reviews each object (the reference's run_both); results compared by
(message, constraint, resource, action), exactly. The pinned drivers'
eval-path counters show the path that served.
"""

from __future__ import annotations

import time

import pytest

from gatekeeper_tpu.utils.profiling import PhaseTimers as JPhaseTimers
from gatekeeper_tpu_torch.ir.carry import tree_from_numpy
from gatekeeper_tpu_torch.kernels import clause_triton
from gatekeeper_tpu_torch.parallel.workload import build_eval_setup
from gatekeeper_tpu_torch.utils import profiling as tprofiling

from . import test_ir_compile as ref
from .test_torch_compile_coverage import all_drivers
from .torch_compiler_cases import (
    F32_TIES,
    WEIRD_TEMPLATE,
    assert_served,
    bare_constraint,
    eval_paths,
    f32_constraint,
    loaded_client,
)


def ref_key(r):
    """test_ir_compile.result_key."""
    return (r.msg, r.constraint["metadata"]["name"],
            (r.resource or {}).get("metadata", {}).get("name"),
            r.enforcement_action)


def run_all(template, constraints, objects) -> dict:
    """test_ir_compile.run_both over every driver: name -> (driver, the
    audit's keys, each object's review keys)."""
    kind = template["spec"]["crd"]["spec"]["names"]["kind"]
    out = {}
    for name, (P, drv) in all_drivers().items():
        client = loaded_client(P.Backend, P.Target, drv, [template],
                               constraints, objects)
        if name != "rego":
            assert kind in drv.compiled_kinds(), f"{kind} did not compile"
        audit = sorted(ref_key(r) for r in client.audit().results())
        reviews = [sorted(ref_key(r) for r in client.review(
            P.Aug(o)).results()) for o in objects[:20]]
        out[name] = (drv, audit, reviews)
    want = out["rego"][1:]
    for name, (_drv, *got) in out.items():
        assert tuple(got) == want, name
    for name in ("torch-pinned", "tpu-pinned"):
        assert_served(out[name][0], [kind], ("device",))
    return out


def test_uncompilable_template_falls_back():
    """A template using `with` stays on the interpreter in the port as in
    the reference and still audits; its eval counters say interp."""
    got = {}
    for name, (P, drv) in all_drivers().items():
        client = loaded_client(
            P.Backend, P.Target, drv, [WEIRD_TEMPLATE],
            [bare_constraint("K8sWeird", "w")],
            [{"apiVersion": "v1", "kind": "Pod",
              "metadata": {"name": "target-me", "namespace": "d"}},
             {"apiVersion": "v1", "kind": "Pod",
              "metadata": {"name": "other", "namespace": "d"}}])
        res = client.audit().results()
        assert [r.resource["metadata"]["name"] for r in res] == \
            ["target-me"], name
        if name != "rego":
            assert drv.compiled_for("K8sWeird") is None
            assert eval_paths(drv)["K8sWeird"] == {"interp"}
            got[name] = {k: (e["reason"], e["dense"]["code"])
                         for k, e in drv.fallback_reasons().items()}
    assert all(g == got["tpu"] for g in got.values()), got


@pytest.mark.parametrize("case", sorted(F32_TIES))
def test_f32_tie_equal(case):
    """The reference's float32 ties (tie_does_not_underfire: :296,
    tie_under_negation: :341, tie_negated_exact_violation: :367) on
    every driver, the pinned ones on the device path."""
    template, mx, objs = F32_TIES[case]
    out = run_all(template, [f32_constraint(template, mx)], objs)
    if case != "tie_under_negation":
        # 16777217 > 16777216 and `not 16777217 < 16777216` hold exactly
        assert out["rego"][1], "the exact violation must surface"


def test_compiled_hlo_introspection():
    """The device program of a compiled template renders at the
    reference's stage names: "jaxpr" and "hlo" give K2's generated
    Triton source for these inputs, "optimized" (PTX) needs the card."""
    _, ct, feats, params, table, derived, _, _ = build_eval_setup(
        8, 2, device="cpu")
    feats, params, table, derived = (tree_from_numpy(x, "cpu")
                                     for x in (feats, params, table, derived))
    src = clause_triton.generate(ct.plans, feats, params, table, derived)[0]
    for stage in ("jaxpr", "hlo"):
        assert tprofiling.compiled_hlo(ct, feats, params, table, derived,
                                       stage=stage) == src
    assert "@triton.jit" in src and "def clause_kernel(" in src
    with pytest.raises(ValueError, match="on the card"):
        tprofiling.compiled_hlo(ct, feats, params, table, derived,
                                stage="optimized")


def test_phase_timers():
    """The port's PhaseTimers counts and times phases as the JAX
    package's does."""
    snaps = []
    for cls in (tprofiling.PhaseTimers, JPhaseTimers):
        pt = cls()
        with pt.phase("sweep"):
            time.sleep(0.01)
        with pt.phase("sweep"):
            pass
        snap = pt.snapshot()
        assert snap["sweep"][1] == 2 and snap["sweep"][0] >= 0.01
        snaps.append({k: v[1] for k, v in snap.items()})
    assert snaps[0] == snaps[1]


def test_case_copies_equal_reference():
    """tests/torch_compiler_cases.py's inputs for these cases are the
    reference suite's own."""
    assert F32_TIES["tie_does_not_underfire"][0] == ref.BIGNUM_TEMPLATE
    assert F32_TIES["tie_under_negation"][0] == ref.NEGATED_BIGNUM_TEMPLATE
    text = open(ref.__file__).read()
    assert WEIRD_TEMPLATE["spec"]["targets"][0]["rego"] in text
    for template, mx, objs in F32_TIES.values():
        assert f'"parameters": {{"max": {mx}}}' in text
        for o in objs:
            assert f'"name": "{o["metadata"]["name"]}"' in text
            assert f'"replicas": {o["spec"]["replicas"]}' in text
