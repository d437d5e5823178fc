"""K1 and K2 against the JAX package's device programs.

Inputs are made with numpy from fixed seeds (or by the shared workload
builders) and fed to both packages; the tolerance is exact equality —
verdicts are bits and pairs are integers. On the CPU the wrappers take
their plain versions; test_torch_gpu.py holds each kernel against its
plain version on the card.
"""

import ast

import jax
import numpy as np
import pytest
import torch

from gatekeeper_tpu.ir.evaljax import _pair_expand
from gatekeeper_tpu.parallel import workload as jwork
from gatekeeper_tpu_torch.ir.carry import tree_from_numpy
from gatekeeper_tpu_torch.kernels import clause_triton
from gatekeeper_tpu_torch.kernels.clause import (
    clause_words,
    clause_words_plain,
    pack_words,
    param_c,
)
from gatekeeper_tpu_torch.kernels.pair_compact import pair_compact
from gatekeeper_tpu_torch.parallel import workload as twork

from .test_torch_frontend import (
    TARGET,
    JTarget,
    fixture_objects,
    library_drivers,
)
from .test_torch_gpu import COMPILED, K1_CASES, random_words
from gatekeeper_tpu import policies as jpol




@pytest.mark.parametrize("w", [1, 16])
@pytest.mark.parametrize("case", K1_CASES)
def test_k1_plain_equals_pair_expand(w, case):
    r, dens, rb, re_, row0, c, pcap = case
    c = c if w == 1 else c * 16 - 3
    words = random_words(r * w + int(dens * 100), r, w, dens)
    valid = (np.arange(r) >= rb) & (np.arange(r) < re_)
    ref = np.asarray(jax.jit(_pair_expand, static_argnums=(4,))(
        words, valid, np.int32(row0), np.int32(c), pcap))
    got = pair_compact(torch.from_numpy(words.view(np.int32)), rb, re_, row0,
                       c, pcap).numpy().view(np.uint32)
    assert got.shape == ref.shape == (pcap + 1, 2)
    assert np.array_equal(got, ref)


def test_k2_plain_equals_scan_on_flagship():
    setup_j = jwork.build_eval_setup(300, 40)
    setup_t = twork.build_eval_setup(300, 40, device="cpu")
    ct = setup_j[1]
    feats, params, table, derived = setup_j[2:6]
    n = next(iter(next(iter(feats.values())).values())).shape[0]
    ref = np.asarray(ct._scan_jit(128)(feats, params, table, derived))
    assert ref.shape == (n, 2)
    f, p, tb, d = (tree_from_numpy(x, "cpu") for x in setup_t[2:6])
    got = clause_words(setup_t[1].plans, f, p, tb, d, chunk=128)
    assert np.array_equal(got.numpy().view(np.uint32), ref)
    assert int(np.unpackbits(ref.view(np.uint8)).sum()) > 0


@pytest.fixture(scope="module")
def library_inputs():
    """Per compiled kind: (JAX CompiledTemplate, JAX inputs, port
    CompiledTemplate, port inputs) over a fixture subset."""
    jd, td = library_drivers()
    objs = fixture_objects(160)
    reviews = [JTarget()._object_to_review(o) for o in objs]
    cons = td._constraints(TARGET)
    out = {}
    for kind in sorted(td._programs):
        kc = [c for c in cons if c["kind"] == kind]
        jct, tct = jd.compiled_for(kind), td.compiled_for(kind)
        out[kind] = (jct, jd._prepare_eval(jct, kind, reviews, kc, None),
                     tct, td._prepare_eval(tct, kind, reviews, kc, None))
    return out


@pytest.mark.parametrize("name", COMPILED)
def test_k2_plain_equals_jax_per_template(library_inputs, name):
    jct, jin, tct, tin = library_inputs[jpol.kind_of(name)]
    feats = jin[0]
    if feats:
        n = next(iter(next(iter(feats.values())).values())).shape[0]
        ref = np.asarray(jct._scan_jit(n)(*jin))
    else:
        fires = np.asarray(jct.fires(*jin))
        ref = pack_words(torch.from_numpy(fires)).numpy().view(np.uint32)
    got = clause_words_plain(tct.plans, *tin, chunk=64)
    assert np.array_equal(got.numpy().view(np.uint32), ref)


def test_k2_emitter_source_parses(library_inputs):
    assert len(library_inputs) == len(COMPILED) == 21
    for kind, (_jct, _jin, tct, tin) in library_inputs.items():
        src, tensors, _ops = clause_triton.generate(tct.plans, *tin)
        tree = ast.parse(src)
        fn = tree.body[-1]
        assert isinstance(fn, ast.FunctionDef) and \
            fn.name == "clause_kernel", kind
        # one pointer argument per input leaf, then the fixed tail
        assert len(fn.args.args) == len(tensors) + 7, kind


class _Ptr:
    """A pointer into a flat tensor, as the emitted source adds offsets."""

    def __init__(self, flat, off=0):
        self.flat, self.off = flat, off

    def __add__(self, other):
        return _Ptr(self.flat, self.off + other)

    __radd__ = __add__


def _tl_on_cpu(pid):
    """The subset of triton.language the K2 emitter writes, in torch on
    the CPU (program instance `pid[0]`): enough to execute a generated
    kernel's source and check what it computes, not how Triton compiles
    it (that is the card's test)."""
    import types

    def t(x):
        return x if isinstance(x, torch.Tensor) else torch.tensor(x)

    def load(p, mask=None, other=0):
        off = t(p.off).long()
        n = p.flat.numel()
        v = p.flat[off.clamp(0, n - 1)]
        inside = (off >= 0) & (off < n)
        if mask is None:
            assert bool(inside.all()), "unmasked gather out of bounds"
            return v
        m = torch.broadcast_to(t(mask), torch.broadcast_shapes(
            v.shape, t(mask).shape))
        assert not bool((m & ~torch.broadcast_to(inside, m.shape)).any())
        return torch.where(m, torch.broadcast_to(v, m.shape),
                           torch.tensor(other, dtype=v.dtype))

    def store(p, v, mask):
        off = t(p.off).long()
        m = torch.broadcast_to(t(mask), off.shape)
        p.flat[off[m]] = torch.broadcast_to(t(v), off.shape)[m].to(
            p.flat.dtype)

    def where(c, a, b):
        a, b = t(a), t(b)
        a = a.float() if a.dtype == torch.float64 else a
        b = b.float() if b.dtype == torch.float64 else b
        a = a.int() if a.dtype == torch.int64 else a
        b = b.int() if b.dtype == torch.int64 else b
        return torch.where(t(c), a, b)

    return types.SimpleNamespace(
        int32=torch.int32, float32=torch.float32, constexpr=object,
        PropagateNan=types.SimpleNamespace(ALL="all"),
        program_id=lambda axis: pid[axis],
        arange=lambda a, b: torch.arange(a, b, dtype=torch.int32),
        zeros=lambda shape, dtype: torch.zeros(shape, dtype=dtype),
        load=load, store=store, where=where,
        minimum=lambda a, b, propagate_nan=None: torch.minimum(t(a), t(b)),
        maximum=lambda a, b, propagate_nan=None: torch.maximum(t(a), t(b)),
        abs=torch.abs,
        sum=lambda x, axis: torch.sum(x, dim=axis).to(torch.int32),
        broadcast_to=lambda x, shape: torch.broadcast_to(t(x), shape))


def run_emitted(src, tensors, n, c):
    """Execute a generated K2 kernel's source on the CPU over its grid."""
    body = "\n".join(line for line in src.splitlines()
                     if not line.startswith("import triton")
                     and line.strip() != "@triton.jit")
    w = max(1, (c + 31) // 32)
    out = torch.zeros(n * w, dtype=torch.int32)
    ptrs = [_Ptr(x.reshape(-1)) for x in tensors]
    block = clause_triton.BLOCK_N
    for pn in range((n + block - 1) // block):
        for pw in range(w):
            ns = {"tl": _tl_on_cpu((pn, pw))}
            exec(body, ns)
            ns["clause_kernel"](*ptrs, _Ptr(out), n, c, w, float("nan"),
                                float("inf"), BLOCK_N=block)
    return out.reshape(n, w)


@pytest.mark.parametrize("name", COMPILED)
def test_k2_emitted_source_computes_plain(library_inputs, name):
    _jct, _jin, tct, tin = library_inputs[jpol.kind_of(name)]
    src, tensors, ops = clause_triton.generate(tct.plans, *tin)
    n = tensors[0].shape[0] if tin[0] else 1
    got = run_emitted(src, tensors, n, param_c(tin[1]))
    assert ops > 0
    assert torch.equal(got, clause_words_plain(tct.plans, *tin, chunk=64))


def test_k2_emitted_source_computes_plain_on_flagship():
    setup = twork.build_eval_setup(300, 40, device="cpu")
    f, p, tb, d = (tree_from_numpy(x, "cpu") for x in setup[2:6])
    plans = setup[1].plans
    src, tensors, _ops = clause_triton.generate(plans, f, p, tb, d)
    n = next(iter(next(iter(f.values())).values())).shape[0]
    got = run_emitted(src, tensors, n, param_c(p))
    want = clause_words_plain(plans, f, p, tb, d, chunk=128)
    assert torch.equal(got, want) and bool((want != 0).any())


def test_wrappers_refuse_other_devices():
    words = torch.zeros((4, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        pair_compact(words, 0, 4, 0, 32, 8)
