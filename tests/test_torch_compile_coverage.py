"""The port's device-compiler coverage against the JAX package's
(tests/test_compile_coverage.py, case for case).

Each counterpart feeds the same inputs to the port's TorchDriver on the
CPU, the JAX package's TpuDriver and the port's RegoDriver: the shipped
libraries' coverage and the compiled_coverage.json ratchet (read, never
written), the library-wide differential sweeps over churn (360 general
objects, 240 PSP pods), the five extended-form kinds of BENCH config 12,
the multiclause identity join, the fallback reason taxonomy (reason
codes, /debug/templates, the fallback metric) and the match-table rows.
Results are compared by the reference's result_key; tolerance: exact.
Where the reference pins the device path the drivers are pinned; where
it lets the cost model decide, each compiled driver runs as decided and
a second one pinned, and the pinned driver's eval-path counters must
show the device or join path served. The suite's conftest sets
GATEKEEPER_TPU_ASYNC_COMPILE=0 (device programs compile inline).
"""

from __future__ import annotations

import ast
import copy
import json
import random
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import bench_configs
from gatekeeper_tpu import policies as jpol
from gatekeeper_tpu.client import Backend as JBackend
from gatekeeper_tpu.control.metrics import REGISTRY as JREGISTRY
from gatekeeper_tpu.ir import TpuDriver
from gatekeeper_tpu.ir.compile import REASON_CODES as JREASON_CODES
from gatekeeper_tpu.ir.compile import Uncompilable as JUncompilable
from gatekeeper_tpu.ops import strtab as jstrtab
from gatekeeper_tpu.target import AugmentedUnstructured as JAug
from gatekeeper_tpu.target import K8sValidationTarget as JTarget
from gatekeeper_tpu_torch import policies as tpol
from gatekeeper_tpu_torch.client import Backend as TBackend
from gatekeeper_tpu_torch.client import RegoDriver as TRegoDriver
from gatekeeper_tpu_torch.control.metrics import REGISTRY as TREGISTRY
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.ir.compile import REASON_CODES as TREASON_CODES
from gatekeeper_tpu_torch.ir.compile import Uncompilable as TUncompilable
from gatekeeper_tpu_torch.ops import strtab as tstrtab
from gatekeeper_tpu_torch.parallel import workload as tworkload
from gatekeeper_tpu_torch.target import AugmentedUnstructured as TAug
from gatekeeper_tpu_torch.target import K8sValidationTarget as TTarget

from . import test_compile_coverage as ref
from . import torch_bench_configs as tbc
from .torch_compiler_cases import (
    LIB_SWEEPS,
    MULTICLAUSE_KIND,
    MULTICLAUSE_REGO,
    MULTICLAUSE_REVIEWS,
    TAXONOMY_REGO,
    XFLIPS_BAD,
    XFLIPS_GOOD,
    XOBJS,
    XREVIEWS,
    assert_served,
    bare_constraint,
    churn,
    eval_paths,
    keys,
    library_constraints,
    library_templates,
    loaded_client,
)
from .torch_fuzz_gen import pin

JAX = types.SimpleNamespace(
    Backend=JBackend, Target=JTarget, Aug=JAug, pol=jpol,
    driver=TpuDriver, REGISTRY=JREGISTRY)
TORCH = types.SimpleNamespace(
    Backend=TBackend, Target=TTarget, Aug=TAug, pol=tpol,
    driver=lambda: TorchDriver(device="cpu"), REGISTRY=TREGISTRY)

LIBS = {"general": bench_configs.GENERAL_CONSTRAINTS,
        "pod-security-policy": bench_configs.PSP_CONSTRAINTS}
COVERAGE_JSON = Path(__file__).resolve().parent.parent / \
    "compiled_coverage.json"


def all_drivers(decided: bool = True) -> dict:
    """name -> (package, driver): the port's RegoDriver ("rego"), and
    TorchDriver on the CPU ("torch") and TpuDriver ("tpu") pinned to the
    device path ("-pinned") and, with `decided`, as the cost model
    decides."""
    out = {"rego": (TORCH, TRegoDriver())}
    for name, P in (("torch", TORCH), ("tpu", JAX)):
        if decided:
            out[name] = (P, P.driver())
        out[name + "-pinned"] = (P, pin(P.driver()))
    return out


def library_client(P, drv, lib):
    return loaded_client(P.Backend, P.Target, drv,
                         library_templates(P.pol, lib),
                         library_constraints(LIBS[lib]), [])


def lib_kinds(P, lib) -> list:
    return sorted(t["spec"]["crd"]["spec"]["names"]["kind"]
                  for t in library_templates(P.pol, lib))


# ------------------------------------------------------------- coverage


@pytest.mark.parametrize("lib", sorted(LIBS))
def test_library_device_coverage(lib):
    """Every shipped kind compiles on the port (dense or join), with no
    fallback reason, as on TpuDriver; a pinned audit of the library's
    own objects then serves every kind it evaluates on the device or
    join path, in both drivers, with results equal to RegoDriver's."""
    objs = ref.lib_objects(lib, 60)
    covs, results, drivers = {}, {}, {}
    for name, (P, drv) in all_drivers(decided=False).items():
        client = library_client(P, drv, lib)
        for o in objs:
            client.add_data(copy.deepcopy(o))
        results[name] = keys(client.audit().results())
        if name != "rego":
            kinds = lib_kinds(P, lib)
            covs[name] = ref.coverage_of(drv, kinds)
            assert covs[name]["interpreter_kinds"] == [], \
                (name, drv.fallback_reasons())
            assert drv.fallback_reasons() == {}
            drivers[name] = drv
    assert covs["torch-pinned"] == covs["tpu-pinned"]
    assert results["rego"] == results["torch-pinned"] == \
        results["tpu-pinned"]
    for drv in drivers.values():
        assert eval_paths(drv), "vacuous: no kind was evaluated"
        assert_served(drv, eval_paths(drv))
    assert set(eval_paths(drivers["torch-pinned"])) == \
        set(eval_paths(drivers["tpu-pinned"]))


def test_coverage_ratchet():
    """The port's coverage equals the committed compiled_coverage.json
    (general 7/7, pod-security-policy 16/16), which this test only
    reads, and TpuDriver's."""
    text = COVERAGE_JSON.read_text()
    recorded = json.loads(text)
    for lib in sorted(LIBS):
        got = {}
        for name, P in (("torch", TORCH), ("tpu", JAX)):
            drv = P.driver()
            library_client(P, drv, lib)
            got[name] = ref.coverage_of(drv, lib_kinds(P, lib))
        assert got["torch"] == got["tpu"] == recorded[lib], (lib, got)
        assert recorded[lib]["device_compiled_kinds"] == \
            recorded[lib]["total_kinds"] == {"general": 7,
                                             "pod-security-policy": 16}[lib]
    assert COVERAGE_JSON.read_text() == text


def test_port_generators_equal_bench_configs():
    """The card's counterparts draw from the port's parallel/workload.py:
    its generators and constraint lists equal bench_configs' on the
    sweeps' seeds and sizes."""
    assert tworkload.synth_mixed_objects(360, seed=7) == \
        bench_configs.synth_mixed_objects(360, seed=7)
    assert tworkload.synth_pods_psp(240, seed=7) == \
        bench_configs.synth_pods_psp(240, seed=7)
    assert tworkload.GENERAL_CONSTRAINTS == bench_configs.GENERAL_CONSTRAINTS
    assert tworkload.PSP_CONSTRAINTS == bench_configs.PSP_CONSTRAINTS


# ------------------------------------------------- differential sweeps


@pytest.mark.parametrize("lib,n", LIB_SWEEPS)
def test_library_differential_sweep(lib, n):
    """The reference's sweep with the device path forced, in both
    compiled drivers, against RegoDriver: the whole library over n
    churned objects, first and after the churn; no library kind served
    from the interpreter, and the same kinds on the device and join
    paths in both compiled drivers."""
    rng = random.Random(5)
    objs = ref.lib_objects(lib, n)
    drivers = all_drivers(decided=False)
    clients = {}
    for name, (P, drv) in drivers.items():
        clients[name] = library_client(P, drv, lib)
        for o in objs:
            clients[name].add_data(o)

    first = {name: keys(c.audit().results()) for name, c in clients.items()}
    assert first["rego"] == first["torch-pinned"] == first["tpu-pinned"]
    assert first["rego"], f"{lib}: vacuous sweep (no violations)"

    replaced, removed = churn(objs, rng)
    for client in clients.values():
        for o in replaced:
            client.add_data(copy.deepcopy(o))
        for o in removed:
            client.remove_data(copy.deepcopy(o))
    second = {name: keys(c.audit().results()) for name, c in clients.items()}
    assert second["rego"] == second["torch-pinned"] == second["tpu-pinned"]
    assert second["rego"] != first["rego"]

    kinds = lib_kinds(TORCH, lib)
    paths = {}
    for name in ("torch-pinned", "tpu-pinned"):
        drv = drivers[name][1]
        paths[name] = {k: p for k, p in eval_paths(drv).items() if k in kinds}
        assert paths[name], f"{lib}: no library kind was evaluated"
        # the churned audit may serve a kind from the delta cache
        assert_served(drv, paths[name], ("device", "join", "delta"))
    assert paths["torch-pinned"] == paths["tpu-pinned"]
    assert any("device" in p for p in paths["torch-pinned"].values())


@pytest.mark.parametrize(
    "kind", [k for k, _, _ in tbc.EXTENDED_FORM_TEMPLATES])
def test_extended_form_differential(kind):
    """Each extended-form kind of BENCH config 12 equals RegoDriver in
    audit and admission, as the cost model decides and pinned, in both
    compiled drivers; the pinned drivers serve it on the device path
    (dense kinds) or the join path (join kinds), the port where
    TpuDriver does."""
    tmpl, params = next((t, p) for k, t, p in tbc.EXTENDED_FORM_TEMPLATES
                        if k == kind)
    outs, drivers = {}, all_drivers()
    for name, (P, drv) in drivers.items():
        client = loaded_client(P.Backend, P.Target, drv, [tmpl],
                               [bare_constraint(kind, "x", params)], XOBJS)
        out = [keys(client.audit().results())]
        for rv in XREVIEWS:
            out.append(sorted(
                r.msg for r in client.review(
                    P.Aug(copy.deepcopy(rv))).results()))
        outs[name] = out
        if name != "rego":
            assert (drv.compiled_for(kind) is not None
                    or drv.join_for(kind) is not None), \
                f"{kind} interpreter-bound: {drv.fallback_reasons()}"
            assert drv.fallback_reasons() == {}
    assert all(o == outs["rego"] for o in outs.values()), outs
    assert any(any(x) for x in outs["rego"]), f"{kind}: vacuous scenario"
    path = "join" if tbc.c12_is_join(kind) else "device"
    for name in ("torch-pinned", "tpu-pinned"):
        drv = drivers[name][1]
        assert_served(drv, [kind], (path,))
        assert (drv.join_for(kind) is not None) == (path == "join")


def test_multiclause_identity_differential():
    """An identity function of two clauses (ns/name OR uid): the own-copy
    exclusion holds when either clause identifies the review's stored
    copy, on the port's join path as on TpuDriver's."""
    tmpl = tbc.xtemplate(MULTICLAUSE_KIND, MULTICLAUSE_REGO)
    outs, drivers = {}, all_drivers()
    for name, (P, drv) in drivers.items():
        client = loaded_client(P.Backend, P.Target, drv, [tmpl],
                               [bare_constraint(MULTICLAUSE_KIND, "m")], XOBJS)
        out = [keys(client.audit().results())]
        for rv in MULTICLAUSE_REVIEWS:
            res = client.review(P.Aug(copy.deepcopy(rv))).results()
            out.append(sorted(r.msg for r in res))
        outs[name] = out
        if name != "rego":
            jc = drv.join_for(MULTICLAUSE_KIND)
            assert jc is not None
            assert len(jc.prog.clauses[0].rev_ident) == 2
            assert_served(drv, [MULTICLAUSE_KIND], ("join",))
    assert all(o == outs["rego"] for o in outs.values()), outs
    assert outs["rego"][3], "true conflict must fire"


# -------------------------------------------------------------- taxonomy


def _fallback_rows(registry) -> dict:
    rows = re.findall(
        r'gatekeeper_tpu_compile_fallback_total\{([^}]*)\} (\d+)',
        registry.render())
    got = {}
    for labels, _val in rows:
        kind = re.search(r'kind="([^"]*)"', labels).group(1)
        got[kind] = re.search(r'reason="([^"]*)"', labels).group(1)
    return got


def _codes(reasons: dict) -> dict:
    return {k: (e["reason"], e["dense"]["code"],
                e["join"]["code"] if e["join"] is not None else None)
            for k, e in reasons.items()}


def _taxonomy_driver(P, kinds):
    drv = P.driver()
    client = P.Backend(drv).new_client([P.Target()])
    for kind in kinds:
        client.add_template(bench_configs._xtemplate(kind,
                                                     TAXONOMY_REGO[kind]))
    return drv, client


def test_fallback_reason_taxonomy():
    """The port records the reference's reason code for the same
    template: in fallback_reasons(), in templates_debug() and on the
    gatekeeper_tpu_compile_fallback_total metric (the bounded code
    set); a device-compiled kind carries no fallback record."""
    got = {}
    for name, P in (("torch", TORCH), ("tpu", JAX)):
        drv, client = _taxonomy_driver(
            P, ["XUnsupportedCall", "XNegatedGenerator"])
        reasons = drv.fallback_reasons()
        assert reasons["XUnsupportedCall"]["reason"] == "call"
        assert reasons["XUnsupportedCall"]["dense"]["code"] == "call"
        assert reasons["XNegatedGenerator"]["reason"] == "join-generator"
        for ent in reasons.values():
            assert ent["reason"] in TREASON_CODES
            assert ent["dense"]["code"] in TREASON_CODES
        debug = drv.templates_debug()["templates"]
        assert debug["XUnsupportedCall"]["state"] == "interpreter"
        assert debug["XUnsupportedCall"]["fallback"]["reason"] == "call"
        assert debug["XNegatedGenerator"]["fallback"]["join"]["code"] == \
            "join-generator"
        client.add_template(P.pol.load("general/httpsonly"))
        debug = drv.templates_debug()["templates"]
        assert debug["K8sHttpsOnly"]["fallback"] is None
        rows = _fallback_rows(P.REGISTRY)
        assert rows.get("XUnsupportedCall") == "call"
        assert rows.get("XNegatedGenerator") == "join-generator"
        assert set(rows.values()) <= TREASON_CODES
        got[name] = (_codes(reasons),
                     {k: (debug[k]["state"], debug[k]["fallback"])
                      for k in ("XUnsupportedCall", "XNegatedGenerator",
                                "K8sHttpsOnly")},
                     {k: rows[k] for k in ("XUnsupportedCall",
                                           "XNegatedGenerator")})
    assert got["torch"] == got["tpu"]


def test_multiline_raise_sites_carry_real_codes():
    """A parameterized join template reports join-input and a
    non-emptiness set count reports count, in the port as in the
    reference; never the internal drift guard."""
    got = {}
    for name, P in (("torch", TORCH), ("tpu", JAX)):
        drv, _ = _taxonomy_driver(P, ["XParamJoin", "XNonEmptyCount"])
        reasons = drv.fallback_reasons()
        assert reasons["XParamJoin"]["reason"] == "join-input"
        assert reasons["XParamJoin"]["join"]["code"] == "join-input"
        assert reasons["XNonEmptyCount"]["reason"] == "count"
        assert reasons["XNonEmptyCount"]["dense"]["code"] == "count"
        assert not any(e["reason"] == "internal" for e in reasons.values())
        got[name] = _codes(reasons)
    assert got["torch"] == got["tpu"]


def test_unknown_reason_code_folds_to_internal():
    """The port's code set is the reference's, and a stray code folds
    into 'internal' with the same detail and text."""
    assert TREASON_CODES == JREASON_CODES
    for exc in (TUncompilable, JUncompilable):
        e = exc("no-such-code", "something odd")
        assert e.code == "internal"
        assert "no-such-code" in e.detail
        e2 = exc("guard", "prose")
        assert e2.code == "guard" and str(e2) == "guard: prose"
    for code in sorted(JREASON_CODES) + ["no-such-code"]:
        t, j = TUncompilable(code, "d"), JUncompilable(code, "d")
        assert (t.code, t.detail, str(t)) == (j.code, j.detail, str(j))


def test_template_update_clears_fallback():
    """Re-ingesting a kind with a compilable body drops its fallback
    record; its pinned audit then runs on the device path and equals
    RegoDriver's, as on TpuDriver."""
    bad = bench_configs._xtemplate("XFlips", XFLIPS_BAD)
    good = bench_configs._xtemplate("XFlips", XFLIPS_GOOD)
    objs = [{"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": f"p{i}", "namespace": "d"},
             "spec": {"bad": i % 3 == 0}} for i in range(12)]
    outs, drivers = {}, all_drivers(decided=False)
    for name, (P, drv) in drivers.items():
        client = loaded_client(P.Backend, P.Target, drv, [bad],
                               [bare_constraint("XFlips", "f")], objs)
        first = keys(client.audit().results())
        if name != "rego":
            assert "XFlips" in drv.fallback_reasons()
            assert_served(drv, ["XFlips"], ("interp",))
        client.add_template(good)
        if name != "rego":
            assert "XFlips" not in drv.fallback_reasons()
            assert drv.compiled_for("XFlips") is not None
        outs[name] = (first, keys(client.audit().results()))
        if name != "rego":
            assert "device" in eval_paths(drv)["XFlips"]
    assert all(o == outs["rego"] for o in outs.values()), outs
    assert outs["rego"][1], "vacuous: the compiled body fires nowhere"


# ------------------------------------------------- match-table widening


def _match_rows(mod, vector: bool):
    t = mod.StringTable()
    m = mod.MatchTables(t, *([torch.device("cpu")] if mod is tstrtab
                             else []))
    if not vector:
        m.MAX_VECTOR_STRLEN = 0  # force the per-string path
    for i in range(4000):
        t.intern(f"reg-{i % 37}.example.com/app-{i}:v{i % 5}")
    t.intern("")            # empty string
    t.intern("x" * 600)     # oversize row (vetoes vectorization)
    for i in range(7):
        m.row("startswith", f"reg-{i}.example.com/")
        m.row("endswith", f":v{i % 5}")
        m.row("contains", f"app-{i * 13}")
        m.row("eq", f"reg-1.example.com/app-{i}:v0")
        m.row("glob", f"reg-{i}.*:v1")
    return np.asarray(m.materialize())


def test_match_table_vectorized_rows_bit_equal():
    """The port's vectorized string-family rows equal its per-string
    rows and the JAX package's, bit for bit."""
    a, b = _match_rows(tstrtab, True), _match_rows(tstrtab, False)
    ref_rows = _match_rows(jstrtab, True)
    assert a.shape == b.shape == ref_rows.shape
    assert (a == b).all() and (a == ref_rows).all()
    assert a.any(), "vacuous: no pattern matched anything"


# ------------------------------------------------ the copies' provenance


def _config12_statements(assigned: tuple, loops_over: tuple = ()) -> str:
    """The source of bench_configs.config12's statements that assign a
    name in `assigned`, and of its loops whose iterable reads a name in
    `loops_over`, in order."""
    src = Path(bench_configs.__file__).read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "config12")
    out = []
    for st in fn.body:
        if isinstance(st, ast.Assign):
            hit = any(isinstance(t, ast.Name) and t.id in assigned
                      for t in st.targets)
        elif isinstance(st, ast.For):
            hit = any(isinstance(n, ast.Name) and n.id in loops_over
                      for n in ast.walk(st.iter))
        else:
            hit = False
        if hit:
            out.append(ast.get_source_segment(src, st))
    return "\n".join(out)


def test_config12_copy_equals_bench_configs():
    """tests/torch_bench_configs.py's copy of BENCH config 12 (which the
    card's phase 22 reads) is bench_configs' own: the same kinds,
    template sources and parameters in order, the same sizes, and the
    same dense and join inventories (config12's own statements run at
    a small n)."""
    want = bench_configs.EXTENDED_FORM_TEMPLATES
    assert [(k, t, p) for k, t, p in tbc.EXTENDED_FORM_TEMPLATES] == \
        [(k, t, p) for k, t, p in want]
    assert [t["spec"]["targets"][0]["rego"]
            for _, t, _ in tbc.EXTENDED_FORM_TEMPLATES] == \
        [t["spec"]["targets"][0]["rego"] for _, t, _ in want]
    assert tbc.xtemplate("K", "r") == bench_configs._xtemplate("K", "r")
    env = {"int": int, "SCALE": 1.0, "range": range, "enumerate": enumerate,
           "synth_mixed_objects": bench_configs.synth_mixed_objects}
    exec(_config12_statements(("n_dense", "n_join")), env)
    assert (env["n_dense"], env["n_join"]) == (tbc.C12_DENSE, tbc.C12_JOIN)
    env.update(n_dense=600, n_join=300)
    exec(_config12_statements(("objs_dense", "objs_join"),
                              ("objs_dense", "n_join")), env)
    assert tbc.c12_dense_objects(600) == env["objs_dense"]
    assert tbc.c12_join_objects(300) == env["objs_join"]
    for kind, _, params in want:
        con = tbc.c12_constraint(kind, params)
        assert con["metadata"]["name"] == kind.lower()
        assert con["spec"] == ({"parameters": params} if params else {})
        assert tbc.c12_is_join(kind) == kind.startswith("XUnique")


def test_case_copies_equal_reference():
    """tests/torch_compiler_cases.py's copies (which the card tests read)
    are the reference suite's own inputs."""
    assert XOBJS == ref.XOBJS and XREVIEWS == ref.XREVIEWS
    text = Path(ref.__file__).read_text()
    for rego in [MULTICLAUSE_REGO, *TAXONOMY_REGO.values(), XFLIPS_BAD,
                 XFLIPS_GOOD]:
        assert rego in text
    for rv in MULTICLAUSE_REVIEWS:
        assert f'"uid": "{rv["metadata"]["uid"]}"' in text
