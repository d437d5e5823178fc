"""The reference's randomized differential suite on the port.

The port of tests/test_differential_fuzz.py: structured-random
Kubernetes objects (missing, empty, wrong-typed, unicode and huge field
values, drawn by tests/torch_fuzz_gen.py, a jax-free copy of the
reference's generators) through three clients over every shipped
template and the reference's CONSTRAINTS: TorchDriver(device="cpu"), the
JAX package's TpuDriver and the port's RegoDriver. Audit, admission and
churn results must be equal in message, constraint and resource.

Each seed runs twice: as the drivers decide (the reference's own
setting: at 120 objects the cost model keeps every compiled kind on the
interpreter), and pinned to the device path in both compiled drivers
(`_use_device_for_batch` always true, `async_warm` off), where the
test asserts that the device path ran. The churn case is pinned and
asserts that the delta cache served one of its audits. Last, the copy
of the generators is held to the reference's: the same seeds draw the
same objects and module sources.

Tolerance: exact equality (result tuples).
"""

from __future__ import annotations

import random

import pytest

from gatekeeper_tpu import policies as jpol
from gatekeeper_tpu.client import Backend as JBackend
from gatekeeper_tpu.ir import TpuDriver
from gatekeeper_tpu.target import AugmentedUnstructured as JAug
from gatekeeper_tpu.target import K8sValidationTarget as JTarget
from gatekeeper_tpu_torch import policies as tpol
from gatekeeper_tpu_torch.client import Backend as TBackend
from gatekeeper_tpu_torch.client import RegoDriver
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.target import AugmentedUnstructured as TAug
from gatekeeper_tpu_torch.target import K8sValidationTarget as TTarget

from . import test_codegen_fuzz as ref_codegen
from . import test_differential_fuzz as ref_fuzz
from . import torch_fuzz_gen as gen


def clients(pinned: bool):
    """(port TorchDriver, TpuDriver, port RegoDriver) clients and the two
    compiled drivers."""
    tdrv, jdrv = TorchDriver(device="cpu"), TpuDriver()
    if pinned:
        gen.pin(tdrv)
        gen.pin(jdrv)
    return ([gen.fuzz_client(TBackend, TTarget, tpol, tdrv),
             gen.fuzz_client(JBackend, JTarget, jpol, jdrv),
             gen.fuzz_client(TBackend, TTarget, tpol, RegoDriver())],
            tdrv, jdrv)


@pytest.mark.parametrize("pinned", [False, True],
                         ids=["as-decided", "pinned"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_audit_and_admission_parity(seed, pinned):
    """The reference's test_fuzz_audit_and_admission_parity: 120 fuzz
    objects, one audit, then 40 single reviews of fresh mutants."""
    rng = random.Random(seed)
    objs = [gen._rand_object(rng, i) for i in range(120)]
    cs, tdrv, jdrv = clients(pinned)
    for c in cs:
        for o in objs:
            c.add_data(o)
    port, jax_, rego = (gen.norm(c.audit().results()) for c in cs)
    assert port == jax_, f"port != TpuDriver audit (seed={seed})"
    assert port == rego, f"port != RegoDriver audit (seed={seed})"
    assert port, f"vacuous fuzz audit (seed={seed})"
    for i in range(40):
        o = gen._rand_object(rng, 10_000 + i)
        got = [gen.norm(cs[0].review(TAug(o)).results()),
               gen.norm(cs[1].review(JAug(o)).results()),
               gen.norm(cs[2].review(TAug(o)).results())]
        assert got[0] == got[1] == got[2], \
            f"admission divergence (seed={seed}, obj={o})"
    if pinned:
        # the device path ran in both compiled drivers, over the same
        # kinds (both packages share the compile decision)
        assert gen.device_kinds(tdrv), tdrv.eval_counts()
        assert gen.device_kinds(tdrv) == gen.device_kinds(jdrv)


@pytest.mark.parametrize("seed", [7])
def test_fuzz_mutation_parity(seed):
    """The reference's churn fuzz, pinned: 80 objects, then 25 random
    replacements (the patch journal), inserts and deletes, each followed
    by an audit held equal to TpuDriver's and RegoDriver's; at least one
    of those audits is delta-served."""
    rng = random.Random(seed)
    objs = [gen._rand_object(rng, i) for i in range(80)]
    cs, tdrv, jdrv = clients(pinned=True)
    for c in cs:
        for o in objs:
            c.add_data(o)
    first = [gen.norm(c.audit().results()) for c in cs]
    assert first[0] == first[1] == first[2] and first[0]
    assert gen.device_kinds(tdrv) and gen.device_kinds(jdrv)
    live = list(objs)
    paths = []
    for step in range(25):
        op, obj = gen.mutate(rng, live, step)
        for c in cs:
            if op == "add":
                c.add_data(obj)
            elif op == "remove":
                c.remove_data(obj)
        got = [gen.norm(c.audit().results()) for c in cs]
        paths.append(tdrv.last_audit_path)
        assert got[0] == got[1], \
            f"port != TpuDriver at step {step} (seed={seed})"
        assert got[0] == got[2], \
            f"port != RegoDriver at step {step} (seed={seed})"
    assert any(p.startswith("delta") for p in paths), paths


@pytest.mark.parametrize("seed", [0, 1, 2, 7, 1000, 1003])
def test_generator_copy_equals_reference(seed):
    """tests/torch_fuzz_gen.py draws what the reference suites draw:
    the same fuzz objects and churn steps (test_differential_fuzz), the
    same random modules and inputs, and the same device-compiler cases
    (test_codegen_fuzz), seed for seed."""
    mine, theirs = random.Random(seed), random.Random(seed)
    assert [gen._rand_object(mine, i) for i in range(60)] == \
        [ref_fuzz._rand_object(theirs, i) for i in range(60)]
    assert gen.CONSTRAINTS == ref_fuzz.CONSTRAINTS
    # the churn loop's draws, replayed inline as the reference makes them
    live_m, live_t = [gen._rand_object(mine, 0)], \
        [ref_fuzz._rand_object(theirs, 0)]
    for step in range(10):
        op, obj = gen.mutate(mine, live_m, step)
        roll = theirs.random()
        if roll < 0.6 and live_t:
            victim = theirs.choice(live_t)
            mutant = ref_fuzz._rand_object(theirs, 0)
            for k in ("apiVersion", "kind"):
                mutant[k] = victim[k]
            mutant["metadata"]["name"] = victim["metadata"]["name"]
            if "namespace" in victim["metadata"]:
                mutant["metadata"]["namespace"] = \
                    victim["metadata"]["namespace"]
            else:
                mutant["metadata"].pop("namespace", None)
            live_t[live_t.index(victim)] = mutant
            want = ("add", mutant)
        elif roll < 0.8:
            new = ref_fuzz._rand_object(theirs, 1000 + step)
            live_t.append(new)
            want = ("add", new)
        elif live_t:
            want = ("remove", live_t.pop(theirs.randrange(len(live_t))))
        else:
            want = (None, None)
        assert (op, obj) == want and live_m == live_t
    mine, theirs = random.Random(seed), random.Random(seed)
    for _ in range(5):
        assert gen.Gen(mine).module() == ref_codegen.Gen(theirs).module()
        assert gen.rand_input(mine) == ref_codegen.rand_input(theirs)
    assert gen.FIELDS == ref_codegen.FIELDS
    # one device-compiler case, drawn inline as the reference draws it
    mine, theirs = random.Random(seed), random.Random(seed)
    for _ in range(3):
        body, tpl, params, objs = gen.template_case(mine)
        want_body = ref_codegen.DevGen(theirs).module().replace(
            "package fz", "package tfz")
        want_params = {theirs.choice(ref_codegen.FIELDS):
                       ref_codegen.rand_value(theirs)
                       for _ in range(theirs.randint(0, 3))}
        want_objs = []
        for i in range(25):
            o = {"apiVersion": "v1", "kind": "Pod",
                 "metadata": {"name": f"o{i}", "namespace": "d"}}
            for f in theirs.sample(ref_codegen.FIELDS,
                                   theirs.randint(0, 4)):
                o[f] = ref_codegen.rand_value(theirs)
            want_objs.append(o)
        assert body == want_body and params == want_params
        assert objs == want_objs
        assert tpl["spec"]["targets"][0]["rego"] == body
