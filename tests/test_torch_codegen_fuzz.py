"""The reference's grammar fuzz on the port.

The port of tests/test_codegen_fuzz.py, drawn by tests/torch_fuzz_gen.py
(a jax-free copy of the reference's generators):

  * random Rego modules (join reordering, memo classes, negation,
    comprehensions, the builtin tail over wrong-typed values): the
    port's rego/codegen.py against its own Interpreter, and both against
    the JAX package's codegen, over a grid of random inputs;
  * random templates through the device compiler: TorchDriver(device=
    "cpu") and TpuDriver, both pinned to the device path, against the
    port's RegoDriver. Both packages share the host front half, so they
    must make the same compile decision for every case
    (`compiled_for("TFz")`); where the port compiled, its audit ran on
    the device path (K2's plain version here; tests/test_torch_gpu.py
    runs the generated Triton kernel on the card).

Seeded; a failure prints the module source for replay. Tolerance: exact
equality (frozen values, result tuples).
"""

from __future__ import annotations

import random

import pytest

from gatekeeper_tpu.client import Backend as JBackend
from gatekeeper_tpu.ir import TpuDriver
from gatekeeper_tpu.rego import codegen as jcodegen
from gatekeeper_tpu.rego import parser as jparser
from gatekeeper_tpu.target import K8sValidationTarget as JTarget
from gatekeeper_tpu.utils import values as jvalues
from gatekeeper_tpu_torch.client import Backend as TBackend
from gatekeeper_tpu_torch.client import RegoDriver
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.rego.codegen import Unsupported, compile_module
from gatekeeper_tpu_torch.rego.interp import UNDEF, Interpreter
from gatekeeper_tpu_torch.rego.parser import parse_module
from gatekeeper_tpu_torch.target import K8sValidationTarget as TTarget
from gatekeeper_tpu_torch.utils.values import freeze, thaw

from . import torch_fuzz_gen as gen


def _jax_codegen(src: str):
    """The JAX package's compiled module for `src`, or None where its
    codegen refuses it."""
    try:
        return jcodegen.compile_module(jparser.parse_module(src))
    except jcodegen.Unsupported:
        return None


@pytest.mark.parametrize("seed", range(8))
def test_codegen_matches_interpreter_and_jax_on_random_modules(seed):
    """The reference's random-module case: 40 modules a seed, 6 random
    inputs each; the port's codegen equals its interpreter and the JAX
    package's codegen (which must accept exactly the same modules)."""
    rng = random.Random(seed)
    tried = 0
    for case in range(40):
        src = gen.Gen(rng).module()
        try:
            module = parse_module(src)
            fn = compile_module(module)
        except Unsupported:
            assert _jax_codegen(src) is None, \
                f"seed={seed} case={case}: only the JAX codegen took\n{src}"
            continue
        jfn = _jax_codegen(src)
        assert jfn is not None, \
            f"seed={seed} case={case}: only the port's codegen took\n{src}"
        interp = Interpreter({"m": module})
        for probe in range(6):
            raw = gen.rand_input(rng)
            inp = freeze(raw)
            want = interp.eval_rule(("fz",), "violation", inp)
            got = fn.__input_call__(inp, freeze({}))
            jgot = jfn.__input_call__(jvalues.freeze(raw),
                                      jvalues.freeze({}))
            tried += 1
            if want is UNDEF:
                want = frozenset()
            assert got == want, (
                f"seed={seed} case={case} probe={probe}\n{src}\n"
                f"input={raw}\ninterp={thaw(want)}\ncodegen={thaw(got)}")
            assert thaw(got) == jvalues.thaw(jgot), (
                f"seed={seed} case={case} probe={probe}\n{src}\n"
                f"input={raw}\nport={thaw(got)}\n"
                f"jax={jvalues.thaw(jgot)}")
    assert tried >= 60, f"fuzzer generated too few comparable cases: {tried}"


@pytest.mark.parametrize("seed", range(8))
def test_device_compiler_parity_on_random_templates(seed):
    """The reference's random-template case, 12 a seed: the port and
    TpuDriver (both pinned) and the port's RegoDriver audit 25 random
    Pods equally; the two compiled drivers compile the same cases for
    the device, at least one a seed, and the port's compiled cases run
    on its device path."""
    rng = random.Random(1000 + seed)
    compiled = 0
    for case in range(12):
        body, tpl, params, objs = gen.template_case(rng)
        tdrv, jdrv = gen.pin(TorchDriver(device="cpu")), gen.pin(TpuDriver())
        outs = [gen.template_audit(TBackend, TTarget, tdrv, tpl, params,
                                   objs),
                gen.template_audit(JBackend, JTarget, jdrv, tpl, params,
                                   objs),
                gen.template_audit(TBackend, TTarget, RegoDriver(), tpl,
                                   params, objs)]
        assert (outs[0] is None) == (outs[1] is None), (
            f"seed={seed} case={case}: one package refused the "
            f"template\n{body}")
        if None in outs:
            continue
        what = (f"seed={seed} case={case}\n{body}\nparams={params}\n"
                f"port={outs[0][:4]}\njax={outs[1][:4]}\n"
                f"rego={outs[2][:4]}")
        assert outs[0] == outs[1], f"port != TpuDriver: {what}"
        assert outs[0] == outs[2], f"port != RegoDriver: {what}"
        on_device = bool(tdrv.compiled_for("TFz"))
        assert on_device == bool(jdrv.compiled_for("TFz")), \
            f"compile decisions differ: {what}"
        if on_device:
            compiled += 1
            assert gen.device_kinds(tdrv) == {"TFz"}, \
                (tdrv.eval_counts(), what)
            assert gen.device_kinds(jdrv) == {"TFz"}, what
    # not every random module device-compiles, but the property must not
    # be vacuous across a seed's cases
    assert compiled >= 1, "no random template device-compiled"
