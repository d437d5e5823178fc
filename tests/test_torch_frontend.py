"""The port's host front half against the JAX package.

Same templates, constraints and manifests through both packages: the
compiled Program IR must print identically, and the intern order plus
every feature / parameter / derived / match-table array handed to the
device must be bit-equal (exact: ids are integers, numbers are the same
f32 conversions of the same values, NaN where absent).
"""

import json
import pathlib

import numpy as np
import pytest

from gatekeeper_tpu import policies as jpol
from gatekeeper_tpu.client import Backend as JBackend
from gatekeeper_tpu.ir import TpuDriver
from gatekeeper_tpu.target import K8sValidationTarget as JTarget
from gatekeeper_tpu_torch import policies as tpol
from gatekeeper_tpu_torch.client import Backend as TBackend
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.parallel.workload import (
    GENERAL_CONSTRAINTS,
    PSP_CONSTRAINTS,
)
from gatekeeper_tpu_torch.target import K8sValidationTarget as TTarget

TARGET = "admission.k8s.gatekeeper.sh"
FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "fleet_scan"
TEMPLATES = jpol.names()


def fixture_objects(n: int) -> list[dict]:
    """The first n objects of the fleet-scan corpus (its JSONL form)."""
    out = []
    with open(FIXTURE / "inventory.jsonl") as f:
        for line in f:
            out.append(json.loads(line))
            if len(out) == n:
                break
    return out


def library_constraints() -> list[dict]:
    return [{"apiVersion": "constraints.gatekeeper.sh/v1beta1", "kind": kind,
             "metadata": {"name": name},
             "spec": ({"parameters": params} if params else {})}
            for kind, name, params in GENERAL_CONSTRAINTS + PSP_CONSTRAINTS]


def library_drivers():
    """(TpuDriver, TorchDriver on the CPU) with the shipped library and
    its constraints ingested in the same order."""
    jd = TpuDriver()
    td = TorchDriver(device="cpu")
    for backend, target, drv, pol in ((JBackend, JTarget, jd, jpol),
                                      (TBackend, TTarget, td, tpol)):
        client = backend(drv).new_client([target()])
        for name in pol.names():
            client.add_template(pol.load(name))
        for c in library_constraints():
            client.add_constraint(c)
    return jd, td


@pytest.fixture(scope="module")
def drivers():
    return library_drivers()


def test_shipped_library_is_copied():
    assert tpol.names() == jpol.names()
    assert len(TEMPLATES) == 23
    for name in TEMPLATES:
        assert tpol.load(name) == jpol.load(name)


@pytest.mark.parametrize("name", TEMPLATES)
def test_program_repr_equal(drivers, name):
    jd, td = drivers
    kind = jpol.kind_of(name)
    assert (kind in td._programs) == (kind in jd._programs)
    if kind in jd._programs:
        assert repr(td._programs[kind]) == repr(jd._programs[kind])
        assert repr(td.compiled_for(kind).program) == \
            repr(jd.compiled_for(kind).program)
    else:
        # inventory-join kinds: the JAX package has a join program; the
        # port serves them from the interpreter and says why
        assert kind in jd._join_progs
        assert td.fallback_reasons()[kind]["reason"] == "join-not-ported"


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_eval_inputs_and_intern_order_equal():
    jd, td = library_drivers()
    objs = fixture_objects(200)
    reviews = [JTarget()._object_to_review(o) for o in objs]
    cons = td._constraints(TARGET)
    kinds = sorted(td._programs)
    assert kinds == sorted(jd._programs) and len(kinds) == 21
    for kind in kinds:
        kc = [c for c in cons if c["kind"] == kind]
        jct, tct = jd.compiled_for(kind), td.compiled_for(kind)
        jin = jd._prepare_eval(jct, kind, reviews, kc, None)
        tin = td._prepare_eval(tct, kind, reviews, kc, None)
        for jtree, ttree in zip(jin, tin):
            jl, tl = list(_leaves(jtree)), list(_leaves(ttree))
            assert [p for p, _ in jl] == [p for p, _ in tl], kind
            for (path, a), (_, b) in zip(jl, tl):
                a = np.asarray(a)
                b = b.numpy()
                if a.dtype == np.uint32:
                    b = b.view(np.uint32)
                assert a.dtype == b.dtype, (kind, path)
                assert np.array_equal(a, b, equal_nan=True), (kind, path)
    assert td.strtab._strs == jd.strtab._strs
    assert np.array_equal(td.match_tables.materialize_packed(),
                          jd.match_tables.materialize_packed())
