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
    clause_work,
    feat_rows,
    pack_words,
    param_c,
    unpack_words,
)
from gatekeeper_tpu_torch.kernels.pair_compact import MAX_TILES as K1_MAX_TILES
from gatekeeper_tpu_torch.kernels.pair_compact import THREADS as K1_THREADS
from gatekeeper_tpu_torch.kernels.pair_compact import pair_compact
from gatekeeper_tpu_torch.kernels.pair_compact import tiling as k1_tiling
from gatekeeper_tpu_torch.kernels.shard_counts import (
    shard_counts,
    shard_counts_plain,
)
from gatekeeper_tpu_torch.parallel import workload as twork

from gatekeeper_tpu.client import Backend as JBackend
from gatekeeper_tpu.ir import TpuDriver
from gatekeeper_tpu_torch.client import Backend as TBackend
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.target import K8sValidationTarget as TTarget

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
        assert len(fn.args.args) == len(tensors) + 9, kind


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
        reshape=lambda x, shape: t(x).reshape(shape),
        broadcast_to=lambda x, shape: torch.broadcast_to(t(x), shape))


def run_emitted(src, tensors, n, c, tile):
    """Execute a generated K2 kernel's source on the CPU over its grid
    at `tile` = (BLOCK_N, BC, WPP, num_warps), as clause_triton.tile
    gives it."""
    body = "\n".join(line for line in src.splitlines()
                     if not line.startswith("import triton")
                     and line.strip() != "@triton.jit")
    w = max(1, (c + 31) // 32)
    out = torch.zeros(n * w, dtype=torch.int32)
    ptrs = [_Ptr(x.reshape(-1)) for x in tensors]
    block, bc, wpp, _warps = tile
    for pn in range((n + block - 1) // block):
        for pw in range((w + wpp - 1) // wpp):
            ns = {"tl": _tl_on_cpu((pn, pw))}
            exec(body, ns)
            ns["clause_kernel"](*ptrs, _Ptr(out), n, c, w, float("nan"),
                                float("inf"), BLOCK_N=block, BC=bc,
                                WPP=wpp)
    return out.reshape(n, w)


@pytest.mark.parametrize("name", COMPILED)
def test_k2_emitted_source_computes_plain(library_inputs, name):
    _jct, _jin, tct, tin = library_inputs[jpol.kind_of(name)]
    src, tensors, ops = clause_triton.generate(tct.plans, *tin)
    n = tensors[0].shape[0] if tin[0] else 1
    got = run_emitted(src, tensors, n, param_c(tin[1]),
                      clause_triton.tile(tin[1]))
    assert ops > 0
    assert torch.equal(got, clause_words_plain(tct.plans, *tin, chunk=64))


@pytest.mark.parametrize("config", [None, (32, 1, 4, 512), (16, 2, 4, 512),
                                    (8, 4, 4, 256)])
def test_k2_emitted_source_computes_plain_on_flagship(config, monkeypatch):
    """The flagship at the shipped tile (`CONFIG`) and at others of other
    row-block sizes, words per program and narrow sizes."""
    if config is not None:
        monkeypatch.setattr(clause_triton, "CONFIG", config)
    setup = twork.build_eval_setup(300, 40, device="cpu")
    f, p, tb, d = (tree_from_numpy(x, "cpu") for x in setup[2:6])
    plans = setup[1].plans
    src, tensors, _ops = clause_triton.generate(plans, f, p, tb, d)
    n = next(iter(next(iter(f.values())).values())).shape[0]
    got = run_emitted(src, tensors, n, param_c(p), clause_triton.tile(p))
    want = clause_words_plain(plans, f, p, tb, d, chunk=128)
    assert torch.equal(got, want) and bool((want != 0).any())


def test_wrappers_refuse_other_devices():
    words = torch.zeros((4, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        pair_compact(words, 0, 4, 0, 32, 8)
    with pytest.raises(ValueError):
        shard_counts(words, 0, 4, 32,
                     torch.zeros((32,), dtype=torch.int32, device="meta"))


# (rows, W, density, r_begin, r_end, c, C): K6's row range and column
# masks, a ragged c, an output shorter than c, and nothing set
K6_CASES = [
    (64, 1, 0.3, 0, 64, 32, 32),
    (300, 2, 0.1, 17, 290, 45, 64),
    (257, 16, 0.05, 0, 200, 500, 500),
    (40, 3, 0.5, 5, 40, 96, 80),
    (128, 1, 0.0, 0, 128, 20, 32),
]


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("case", K6_CASES)
def test_k6_plain_equals_jax_masked_column_sum(case, accumulate):
    """shard_counts_plain against the JAX package's audit step
    (parallel/collectives.py make_audit_step: the masked column sum of
    the verdicts, rows at or past n_valid masked) on one device, its
    eval_fn handing back the unpacked verdicts with the rows below
    r_begin cleared."""
    import jax.numpy as jnp

    from gatekeeper_tpu.parallel.collectives import make_audit_step
    from gatekeeper_tpu.parallel.mesh import make_mesh

    rows, w, dens, rb, re_, c, C = case
    words = random_words(rows * w + c, rows, w, dens)
    bits = ((words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
            ).reshape(rows, 32 * w)[:, :c].astype(bool)

    def eval_fn(f, p, t, d):
        keep = jnp.arange(rows)[:, None] >= rb
        return f["x"]["fires"] & keep & (p["x"]["on"][None, :] > 0)

    mesh = make_mesh(devices=jax.devices()[:1], data=1, model=1)
    _fires, counts = make_audit_step(eval_fn, mesh)(
        {"x": {"fires": bits}}, {"x": {"on": np.ones(c, np.int32)}},
        np.zeros((1, 1), np.uint32), {}, np.int32(re_))
    init = torch.arange(C, dtype=torch.int32) * 3 - 5
    out = shard_counts_plain(torch.from_numpy(words.view(np.int32)), rb,
                             re_, c, init.clone(), accumulate)
    k = min(c, C, 32 * w)
    want = np.zeros(C, np.int64)
    want[:k] = np.asarray(counts)[:k]
    if accumulate:
        want += init.numpy()
    assert out.dtype == torch.int32 and out.tolist() == want.tolist()
    assert (np.asarray(counts).sum() > 0) == (dens > 0)


# ---------------------------------------------------------------- K2 cases
# The emitted source against the plain version and the JAX package's
# words at shapes the corpus fixture does not give: N not a multiple of
# the row block, C not a multiple of 32, and templates chosen for one
# construct each. Exact equality, as above.

NUMTIE_REGO = """
package k8snumtie

violation[{"msg": "over"}] {
  input.review.object.spec.replicas > input.parameters.max
}

violation[{"msg": "eq"}] {
  w := input.review.object.spec.weights[_]
  w == input.parameters.weights[_]
}

violation[{"msg": "le"}] {
  w := input.review.object.spec.weights[_]
  w <= input.parameters.floor
}

violation[{"msg": "ne"}] {
  t := input.review.object.spec.tags[_]
  t != input.parameters.tag
}
"""
NUMTIE_TEMPLATE = {
    "apiVersion": "templates.gatekeeper.sh/v1beta1",
    "kind": "ConstraintTemplate", "metadata": {"name": "k8snumtie"},
    "spec": {"crd": {"spec": {"names": {"kind": "K8sNumTie"}}},
             "targets": [{"target": TARGET, "rego": NUMTIE_REGO}]}}
# f32-equal numbers with different canonical ids (2^24 and 2^24 + 1,
# 0.1 and 0.1 + 2^-60), and values of every kind
TIE_NUMS = [16777216, 16777217, 16777215, 3, 3.0000001, 0.1,
            0.1 + 2.0 ** -60, -0.0, 0]
MIXED = TIE_NUMS + ["1", "16777216", True, False, None, [1], {"a": 1}]


def _numtie_inputs(n_obj: int, n_cons: int, seed: int):
    """(JAX CompiledTemplate, JAX inputs, port CompiledTemplate, port
    inputs) for K8sNumTie over numpy-seeded objects and constraints."""
    rng = np.random.default_rng(seed)

    def pick(pool, k):
        return [pool[int(i)] for i in rng.integers(0, len(pool), k)]

    cons = []
    for i in range(n_cons):
        params = {"max": pick(TIE_NUMS, 1)[0],
                  "weights": pick(MIXED, int(rng.integers(0, 4))),
                  "floor": pick(TIE_NUMS, 1)[0],
                  "tag": pick(MIXED, 1)[0]}
        if i % 7 == 3:
            del params["floor"]
        cons.append({"apiVersion": "constraints.gatekeeper.sh/v1beta1",
                     "kind": "K8sNumTie", "metadata": {"name": f"c{i}"},
                     "spec": {"parameters": params}})
    objs = []
    for i in range(n_obj):
        spec = {"replicas": pick(TIE_NUMS, 1)[0],
                "weights": pick(MIXED, int(rng.integers(0, 5))),
                "tags": pick(MIXED, int(rng.integers(0, 3)))}
        if i % 5 == 2:
            del spec["replicas"]
        objs.append({"apiVersion": "apps/v1", "kind": "Deployment",
                     "metadata": {"name": f"d{i}", "namespace": "ns"},
                     "spec": spec})
    jd, td = TpuDriver(), TorchDriver(device="cpu")
    for backend, drv in ((JBackend, jd), (TBackend, td)):
        client = backend(drv).new_client(
            [JTarget() if drv is jd else TTarget()])
        client.add_template(NUMTIE_TEMPLATE)
        for c in cons:
            client.add_constraint(c)
    reviews = [JTarget()._object_to_review(o) for o in objs]
    kc = [c for c in td._constraints(TARGET) if c["kind"] == "K8sNumTie"]
    jct, tct = jd.compiled_for("K8sNumTie"), td.compiled_for("K8sNumTie")
    assert jct is not None and tct is not None
    return (jct, jd._prepare_eval(jct, "K8sNumTie", reviews, kc, None),
            tct, td._prepare_eval(tct, "K8sNumTie", reviews, kc, None))


def _rows(tree, n):
    return {s: {k: a[:n] for k, a in arrs.items()}
            for s, arrs in tree.items()}


def _check_three_ways(jct, jin, tct, tin, n=None):
    """JAX words == plain words == the emitted source's words, on the
    first n feature rows (all when None); returns the words."""
    if n is not None:
        jin = (_rows(jin[0], n),) + tuple(jin[1:])
        tin = (_rows(tin[0], n),) + tuple(tin[1:])
    feats = tin[0]
    rows = feat_rows(feats) if feats else 1
    if feats:
        ref = np.asarray(jct._scan_jit(rows)(*jin))
    else:
        ref = pack_words(torch.from_numpy(
            np.asarray(jct.fires(*jin)))).numpy().view(np.uint32)
    plain = clause_words_plain(tct.plans, *tin, chunk=32)
    assert np.array_equal(plain.numpy().view(np.uint32), ref)
    src, tensors, _ops = clause_triton.generate(tct.plans, *tin)
    got = run_emitted(src, tensors, rows, param_c(tin[1]),
                      clause_triton.tile(tin[1]))
    assert torch.equal(got, plain)
    return plain


@pytest.mark.parametrize("n_obj,n_cons", [(77, 37), (33, 70), (5, 1)])
def test_k2_emitted_numeric_ties_and_kinds(n_obj, n_cons):
    """Cmp on numbers with nid ties (gt, le), auto eq over mixed kinds
    (arrays and objects compare as maybe) and auto ne; C = 37 and 70 are
    not multiples of 32 (70 spans 3 words of a 4-word program), N = 77
    and 33 not multiples of the row block."""
    jct, jin, tct, tin = _numtie_inputs(n_obj, n_cons, seed=n_obj)
    words = _check_three_ways(jct, jin, tct, tin, n_obj)
    bits = unpack_words(words.numpy())[:, :n_cons]
    assert bits.any() and (bits.size < 64 or not bits.all())


def _walk(e):
    yield e
    for f in ("lhs", "rhs", "e", "row", "sid", "base"):
        x = getattr(e, f, None)
        if x is not None and hasattr(x, "__dataclass_fields__"):
            yield from _walk(x)
    for x in getattr(e, "items", ()) or ():
        yield from _walk(x)


def _constructs(tct, tin) -> set:
    out = set()
    if not tin[1]:
        out.add("parameterless")
    if tin[3]:
        out.add("derived")
    for plan in tct.plans:
        for g in plan.clause.guards:
            for x in _walk(g.expr):
                out.add(type(x).__name__)
    return out


@pytest.mark.parametrize("construct", ["parameterless", "derived",
                                       "MatchLookup", "SumReduce",
                                       "DerivedVal", "Arith"])
def test_k2_emitted_construct_at_odd_rows(library_inputs, construct):
    """Each construct through the first library template that has it,
    on 77 rows (not a multiple of the row block)."""
    hits = [k for k, (_j, _ji, tct, tin) in sorted(library_inputs.items())
            if construct in _constructs(tct, tin)]
    assert hits, f"no compiled template has {construct}"
    jct, jin, tct, tin = library_inputs[hits[0]]
    n = min(77, feat_rows(tin[0])) if tin[0] else None
    _check_three_ways(jct, jin, tct, tin, n)


def test_k2_flagship_at_odd_shapes():
    """The flagship (SumReduce, MatchLookup, key compares) with C = 70
    and N = 77: a partial word group and a partial row block."""
    setup_j = jwork.build_eval_setup(120, 70)
    setup_t = twork.build_eval_setup(120, 70, device="cpu")
    f, p, tb, d = (tree_from_numpy(x, "cpu") for x in setup_t[2:6])
    _check_three_ways(setup_j[1], tuple(setup_j[2:6]), setup_t[1],
                      (f, p, tb, d), 77)


def test_k2_flagship_hoists_col_work_out_of_object_loops():
    """In the flagship's generated source, no statement inside a loop
    over an object axis depends on the parameter side alone: every
    parameter load and every COL-only operation sits outside the object
    loops. Object-axis loop variables are those that index feature rows
    (`rows * k + i`)."""
    setup = twork.build_eval_setup(64, 40, device="cpu")
    f, p, tb, d = (tree_from_numpy(x, "cpu") for x in setup[2:6])
    src, _tensors, _ops = clause_triton.generate(setup[1].plans, f, p, tb,
                                                 d)
    fn = ast.parse(src).body[-1]
    obj_vars = {n.right.id for n in ast.walk(fn)
                if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Add)
                and isinstance(n.right, ast.Name)
                and "rows" in {x.id for x in ast.walk(n.left)
                               if isinstance(x, ast.Name)}}
    assert obj_vars, "no object-axis loop found"
    row_dep = {"rows", "rmask", "orow"} | obj_vars
    checked = []

    def visit(stmts, in_obj):
        for st in stmts:
            if isinstance(st, ast.For):
                visit(st.body, in_obj or st.target.id in obj_vars)
                continue
            if not isinstance(st, ast.Assign):
                continue
            target = st.targets[0].id
            deps = {x.id for x in ast.walk(st.value)
                    if isinstance(x, ast.Name)}
            dep = bool(deps & row_dep) or target.startswith("acc")
            if dep:
                row_dep.add(target)
            if in_obj:
                checked.append(target)
                assert dep, f"{ast.unparse(st)} is COL-only in an object loop"

    visit(fn.body, False)
    assert len(checked) > 10


@pytest.mark.parametrize("rows", [1, 255, 256, 57344, 262144, 262145,
                                  1_000_000])
def test_k1_tiling_covers_rows(rows):
    """K1's tiles cover every row once, with at most MAX_TILES tiles."""
    rpt, tiles = k1_tiling(rows)
    span = K1_THREADS * rpt
    assert 1 <= tiles <= K1_MAX_TILES
    assert (tiles - 1) * span < rows <= tiles * span


def test_k2_work_counts_pair_trips_from_the_ir(monkeypatch):
    """clause_work reads the flagship's two clauses' axes (16 label
    slots x 4 parameter entries each) from the IR and the shapes, and no
    tile of the emitter moves it; emitted_ops does move with the tile."""
    setup = twork.build_eval_setup(300, 40, device="cpu")
    f, p, tb, d = (tree_from_numpy(x, "cpu") for x in setup[2:6])
    plans = setup[1].plans
    n, c = feat_rows(f), param_c(p)
    work = clause_work(plans, f, p, tb, d)
    assert [len(pl.axis_order) for pl in plans] == [2, 2]
    assert work["pair_trips"] == n * c * (16 * 4 + 16 * 4)
    leaves = [a for tree in (f, p, d) for arrs in tree.values()
              for a in arrs.values()] + [tb]
    assert work["bytes"] == sum(a.numel() * a.element_size()
                                for a in leaves) + n * ((c + 31) // 32) * 4
    ops = set()
    for cfg in ((32, 1, 4, 512), (16, 4, 4, 512)):
        monkeypatch.setattr(clause_triton, "CONFIG", cfg)
        ops.add(clause_triton.emitted_ops(plans, f, p, tb, d))
        assert clause_work(plans, f, p, tb, d) == work
    assert len(ops) == 2
