"""The port's program store (ir/aot.py) and warm-boot prewarm against the
JAX package's.

The port's counterparts of tests/test_coldstart.py's AOT store tests, on
the CPU. The same inputs go through both packages and each test requires
exact equality: fingerprints, the store's manifest (sigs, entries and
their order, eviction, reload), audit results and per-kind eval paths.
The CPU has no Triton, so where the port would load a stored K2 variant
a stand-in takes its place at one named seam: CompiledTemplate.preload_aot
(a warm boot's load), a stand-in group of files (a stored variant), or a
stand-in acquisition that raises WouldCompile under the guard (a stored
variant gone). The JAX package runs its own AotStore and serialized
executables, as its tests do. Every store lives under tmp_path.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from gatekeeper_tpu import policies as jpol
from gatekeeper_tpu.client import Backend as JBackend
from gatekeeper_tpu.ir import TpuDriver
from gatekeeper_tpu.ir import aot as jaot
from gatekeeper_tpu.target import K8sValidationTarget as JTarget
from gatekeeper_tpu_torch import policies as tpol
from gatekeeper_tpu_torch.client import Backend as TBackend
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.ir import aot as taot
from gatekeeper_tpu_torch.ir import evaltorch as teval
from gatekeeper_tpu_torch.kernels import clause_triton
from gatekeeper_tpu_torch.target import K8sValidationTarget as TTarget

from .test_torch_frontend import TARGET, fixture_objects, library_drivers

LABEL_KEYS = ["owner", "team", "env", "cost", "tier",
              "zone", "org", "app", "rel", "stage"]
KIND = "K8sRequiredLabels"
# (package tag, Backend, target, policies, driver factory, aot module)
SIDES = (("jax", JBackend, JTarget, jpol,
          lambda **kw: TpuDriver(**kw), jaot),
         ("torch", TBackend, TTarget, tpol,
          lambda **kw: TorchDriver(device="cpu", **kw), taot))


@pytest.fixture
def fresh_xla_cache(tmp_path, monkeypatch):
    """tests/test_coldstart.py's fixture: the JAX package's persistent XLA
    cache isolated per test, so that its first compiles are fresh and
    serialize (an executable XLA loaded from its own cache may not)."""
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


@pytest.fixture
def async_env():
    """Drivers made inside `with async_env():` start with async warm on
    (the package default; the suite's conftest turns it off)."""
    class _Scope:
        def __enter__(self):
            os.environ["GATEKEEPER_TPU_ASYNC_COMPILE"] = "1"

        def __exit__(self, *exc):
            os.environ["GATEKEEPER_TPU_ASYNC_COMPILE"] = "0"
    return _Scope


def driver(side, aot_dir=None):
    """tests/test_coldstart.py's _single_device_driver, for either
    package: the cost model pinned to the device path."""
    drv = side[4](aot_dir=aot_dir)
    if isinstance(drv, TpuDriver):
        drv._mesh = None
    drv._dev_batch_lat_s = 1e-4
    return drv


def add_constraint(client, k):
    client.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": KIND,
        "metadata": {"name": f"need-{LABEL_KEYS[k]}"},
        "spec": {"parameters": {"labels": [{"key": LABEL_KEYS[k]}]}}})


def labels_client(side, drv, n, n_cons):
    """tests/test_coldstart.py's _labels_client: requiredlabels, n_cons
    constraints, n Namespaces with two of every three labels."""
    _tag, backend, target, pol, _make, _aot = side
    client = backend(drv).new_client([target()])
    client.add_template(pol.load("general/requiredlabels"))
    for k in range(n_cons):
        add_constraint(client, k)
    for i in range(n):
        labels = {LABEL_KEYS[j]: "x" for j in range(len(LABEL_KEYS))
                  if (i + j) % 3}
        client.add_data({"apiVersion": "v1", "kind": "Namespace",
                         "metadata": {"name": f"ns{i:05d}",
                                      "labels": labels}})
    return client


def key(results):
    return sorted((r.msg, (r.resource or {}).get("metadata", {})
                   .get("name", "")) for r in results)


def counts(side) -> dict:
    return dict(side[5].COMPILE_COUNTS)


def delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def wait_until(cond, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)


# ------------------------------------------------------ (a) fingerprints


def test_fingerprints_equal_for_every_shipped_template():
    """The resolved programs' fingerprints, over the same ingest order:
    CompiledTemplate's for the 21 device-compiled templates and
    JoinCompiled's for the 2 joins, equal to the JAX package's."""
    jd, td = library_drivers()
    kinds = sorted(set(td._programs) | set(td._join_progs))
    assert len(kinds) == 23
    joins = 0
    for kind in kinds:
        jct, tct = jd.compiled_for(kind), td.compiled_for(kind)
        if tct is None:
            jct, tct = jd.join_for(kind), td.join_for(kind)
            joins += 1
        assert tct.fingerprint == jct.fingerprint, kind
    assert joins == 2
    assert not hasattr(teval, "program_fingerprint") or \
        teval.program_fingerprint is taot.program_fingerprint


# --------------------------------------------------------- (b) manifest


def test_manifest_eviction_and_reload_equal(tmp_path, monkeypatch):
    """The same record_sig and save sequence through both stores with
    max_programs = 2: equal sigs_for and entries_for (order included),
    the oldest entry's files deleted, and a reload that sees only the
    survivors. The JAX store stores a stand-in payload (its serializer
    stubbed: the manifest is what is compared); the port's, a stand-in
    group of two files."""
    from jax.experimental import serialize_executable as se

    monkeypatch.setattr(se, "serialize", lambda c: (b"stand-in", None, None))
    monkeypatch.setattr(se, "deserialize_and_load", lambda *a: object())
    stores = {}
    for tag, mod in (("jax", jaot), ("torch", taot)):
        st = mod.AotStore(str(tmp_path / tag))
        assert st.enabled
        st.max_programs = 2
        stores[tag] = st
    fp = "fp-test"
    keys = []
    for n in (8, 16, 32):  # three shapes -> three entries
        asig = jaot.arg_sig((np.zeros((n,), np.float32),))
        for tag, st in stores.items():
            st.record_sig(fp, ("k", n))
            st.record_sig(fp, ("k", n))  # a repeat is not a new line
        k = stores["jax"].entry_key(fp, "eval", (n,), asig)
        assert stores["torch"].entry_key(fp, "eval", (n,), asig) == k
        assert stores["jax"].save(k, None, fp, "eval", (n,), asig)
        assert stores["torch"].save(
            k, {"clause_kernel.cubin": bytes([n]) * n,
                "variant.json": b"{}"}, fp, "eval", (n,), asig)
        keys.append(k)

    def entries(st):
        return [(e["tag"], e["static"], e["asig"]) for e in
                st.entries_for(fp)]

    jst, tst = stores["jax"], stores["torch"]
    import torch

    # keyed by what a kernel cannot cross; on a host without a card, the
    # CPU and torch
    assert os.path.basename(tst.dir) == f"cpu-torch{torch.__version__}"
    assert entries(tst) == entries(jst) and len(entries(tst)) == 2
    assert [e["file"] for e in tst.entries_for(fp)] == \
        [e["file"][:-len(".aotx")] for e in jst.entries_for(fp)] == keys[1:]
    assert tst.sigs_for(fp) == jst.sigs_for(fp) == {("k", 8), ("k", 16),
                                                     ("k", 32)}
    # the oldest entry's files are gone, the survivors' are there
    assert not os.path.exists(os.path.join(jst.dir, keys[0] + ".aotx"))
    assert not os.path.exists(os.path.join(tst.dir, keys[0]))
    assert sorted(os.listdir(os.path.join(tst.dir, keys[2]))) == [
        "clause_kernel.cubin", "variant.json"]
    assert tst.load(keys[2])["clause_kernel.cubin"] == bytes([32]) * 32
    assert tst.load(keys[0]) is None
    for tag, mod in (("jax", jaot), ("torch", taot)):
        again = mod.AotStore(str(tmp_path / tag))
        assert again.programs_count() == 2
        stores[tag] = again
    assert entries(stores["torch"]) == entries(stores["jax"])
    assert stores["torch"].sigs_for(fp) == stores["jax"].sigs_for(fp)
    # the manifests hold the same records, line for line
    lines = {}
    for tag, st in stores.items():
        with open(os.path.join(st.dir, st.MANIFEST)) as f:
            lines[tag] = [ln.replace(".aotx", "") for ln in f]
    assert lines["torch"] == lines["jax"]


# ----------------------------------------------- (c) an unusable directory


def test_unusable_dir_disables_store_and_serves(tmp_path):
    """A file where the store's directory should be: the store stays
    disabled and the audit equals TpuDriver's."""
    bad = tmp_path / "occupied"
    bad.write_text("not a directory")
    got = []
    for side in SIDES:
        drv = driver(side, aot_dir=str(bad))
        assert not drv.aot.enabled
        assert drv.warm_status()["aot"]["enabled"] is False
        got.append(key(labels_client(side, drv, 256, 2).audit().results()))
    assert got[0] == got[1] and len(got[0]) > 0


# ------------------------------------------------------- (d) warm boot


def test_warm_boot_adopts_stored_sigs(tmp_path, fresh_xla_cache,
                                      monkeypatch, async_env):
    """A second driver on the store's directory, async warm on: the
    stored sigs are adopted before any sweep, and its first audit runs
    on the device, none on the interpreter, with no compile — in both
    packages. The port's seam is preload_aot (the CPU has no Triton):
    it returns {"eval": 1}, as one loaded variant would."""
    monkeypatch.setattr(teval.CompiledTemplate, "preload_aot",
                        lambda self: {"eval": 1})
    runs = []
    for side in SIDES:
        aot_dir = str(tmp_path / side[0])
        d1 = driver(side, aot_dir=aot_dir)
        got1 = key(labels_client(side, d1, 2048, 5).audit().results())
        fp = d1.compiled_for(KIND).fingerprint
        assert d1.aot.sigs_for(fp), "the first boot records its sweep sig"
        with async_env():
            d2 = driver(side, aot_dir=aot_dir)
            assert d2.async_warm
            c2 = labels_client(side, d2, 2048, 5)
        wait_until(lambda: d2.warm_status()["warm"])
        assert d2.warm_status()["warm"] >= 1, \
            "prewarm must mark stored sweep signatures warm before a sweep"
        adopted = set(d2._warm_restored)
        assert adopted == d2.aot.sigs_for(fp)
        base = counts(side)
        got2 = key(c2.audit().results())
        d = delta(base, counts(side))
        assert d["fresh"] == 0 and d["cache"] == 0
        # the first dispatch consumed the adoption
        assert not d2._warm_restored & adopted
        runs.append((got1, got2, dict(d2._eval_counts),
                     len(adopted)))
    assert runs[0] == runs[1]
    got1, got2, evals, n = runs[1]
    assert got1 == got2 and len(got1) > 0 and n == 1
    assert evals == {(KIND, "device"): 1}


# ----------------------------------- (e) an adopted sig with no variant


@pytest.mark.parametrize("host_rate,n", [(1e9, 2048), (None, 9000)],
                         ids=["reference-host-model", "device-chosen"])
def test_adopted_sig_without_executable_serves_host_not_inline_compile(
        tmp_path, fresh_xla_cache, monkeypatch, async_env, host_rate, n):
    """tests/test_coldstart.py's test of the same name through both
    packages: an adopted sig whose stored program is gone must not
    compile inline on the serving path. The sig is un-adopted, the
    interpreter serves, the program re-warms in the background, and a
    later audit runs on the device. The JAX package's stored executables
    are deleted; the port's stand-in acquisition raises WouldCompile
    under the guard, as a store miss does, and evaluates outside it (the
    background warm).

    With the reference test's host model (1e9 pairs/s) the cost model
    serves the first audit from the host before any dispatch, and the
    guard meets the adopted sig at the edit's audit, which then blocks
    on the warm (its host estimate is past the 30 s budget). With the
    default host model the first audit takes the device, the guarded
    dispatch misses and the sig is un-adopted there; that case sweeps
    9,000 objects, since below one chunk (8,192 rows) TpuDriver defers
    its sweep to consume time, outside the guard, where the port
    launches K2 at dispatch (ROADMAP §C)."""
    words = teval.CompiledTemplate.words
    guarded = []

    def acquiring_words(self, *a, **k):
        if taot.inline_compile_forbidden():
            guarded.append(self.kind)
            raise taot.WouldCompile(self.kind, "eval")
        return words(self, *a, **k)

    monkeypatch.setattr(teval.CompiledTemplate, "words", acquiring_words)
    runs = []
    for side in SIDES:
        aot_dir = str(tmp_path / side[0])
        d1 = driver(side, aot_dir=aot_dir)
        got1 = key(labels_client(side, d1, n, 5).audit().results())
        for root, _dirs, files in os.walk(aot_dir):
            for fn in files:
                if fn.endswith(".aotx"):
                    os.unlink(os.path.join(root, fn))
        with async_env():
            d2 = driver(side, aot_dir=aot_dir)
            if host_rate:
                d2._host_pair_rate = host_rate
            c2 = labels_client(side, d2, n, 5)
        ct = d2.compiled_for(KIND)
        d2._mark_stored_sigs_warm(ct.fingerprint, {"eval": 1})
        assert d2._warm_restored, "adoption precondition"
        got2 = key(c2.audit().results())
        after_first = (dict(d2._eval_counts), bool(d2._warm_restored))
        wait_until(lambda: not d2.warm_status()["compiling"])
        # a library edit inside the C bucket: a real re-sweep at the
        # re-warmed shape, with a host model that prefers the device
        d2._host_pair_rate = 100.0
        add_constraint(c2, 5)
        c2.audit()
        runs.append((got1, got2, after_first, dict(d2._eval_counts),
                     bool(d2._warm_restored)))
    assert runs[0] == runs[1]
    got1, got2, first, final, restored = runs[1]
    assert got1 == got2
    assert first == ({(KIND, "interp"): 1}, bool(host_rate))
    assert final == {(KIND, "interp"): 1, (KIND, "device"): 1}
    assert not restored
    assert guarded == [KIND], "exactly the adopted dispatch was guarded"


# ------------------------------------ (f) threads and template changes


def test_guard_is_per_thread_and_template_change_drops_adoption(
        tmp_path, async_env):
    """no_inline_compile holds on the thread that entered it, not on the
    driver's warm thread; a template change drops the kind's adopted
    sigs — in both packages."""
    for side in SIDES:
        mod = side[5]
        seen = []
        with async_env():
            drv = driver(side, aot_dir=str(tmp_path / side[0]))
        client = labels_client(side, drv, 64, 2)
        with mod.no_inline_compile():
            assert getattr(mod._guard, "active", False)
            ev = drv._spawn_warm(
                ("probe-sig",), KIND,
                lambda: seen.append(getattr(mod._guard, "active", False)))
            ev.wait(10)
            other = threading.Thread(target=lambda: seen.append(
                getattr(mod._guard, "active", False)))
            other.start()
            other.join(10)
            with mod.no_inline_compile():
                pass
            assert getattr(mod._guard, "active", False), "scopes nest"
        assert not getattr(mod._guard, "active", False)
        assert seen == [False, False], side[0]
        ct = drv.compiled_for(KIND)
        drv.aot.record_sig(ct.fingerprint, (KIND, "stand-in"))
        drv._mark_stored_sigs_warm(ct.fingerprint, {"eval": 1})
        assert (KIND, "stand-in") in drv._warm_restored
        edited = side[3].load("general/requiredlabels")
        edited["spec"]["targets"][0]["rego"] += "\nedit_marker = true\n"
        client.add_template(edited)
        assert not drv._warm_restored and \
            (KIND, "stand-in") not in drv._warm_done, side[0]


# ------------------------------------------------ (g) K2's stored source


def test_k2_stored_source_round_trips(tmp_path, monkeypatch):
    """A K2 variant saved as the acquisition saves it (its generated
    source, Triton's group and VARIANT_META; the group is a stand-in,
    since the CPU has no Triton) and loaded by entry_key gives back
    clause_triton.generate's source for the same inputs. Its key is the
    one the JAX package's store computes for the same fingerprint, tag,
    static config and argument signature."""
    jd, td = library_drivers()
    objs = fixture_objects(64)
    reviews = [TTarget()._object_to_review(o) for o in objs]
    cons = td._constraints(TARGET)
    store = taot.AotStore(str(tmp_path / "aot"))
    group = {"clause_kernel.json": b'{"name": "clause_kernel"}',
             "clause_kernel.cubin": b"\x7fELF stand-in"}
    monkeypatch.setattr(clause_triton, "_group_files", lambda h: dict(group))

    class Compiled:
        hash = "0f" * 32

    checked = 0
    for kind in ("K8sRequiredLabels", "K8sPSPHostFilesystem",
                 "K8sContainerLimits"):
        tct, jct = td.compiled_for(kind), jd.compiled_for(kind)
        assert tct.fingerprint == jct.fingerprint
        kc = [c for c in cons if c["kind"] == kind]
        feats, enc, table, derived = td._prepare_eval(tct, kind, reviews,
                                                      kc, None)
        src, _tensors, _ops = clause_triton.generate(tct.plans, feats, enc,
                                                     table, derived)
        variant = clause_triton.variant_key(feats, enc, table, derived,
                                            len(reviews))
        k = store.entry_key(tct.fingerprint, "eval", (), variant)
        assert k == jaot.AotStore().entry_key(jct.fingerprint, "eval", (),
                                              variant)
        recipe = {"grid": [1, 1], "args": [["i", 64]], "meta": {}}
        files = clause_triton._variant_files(src, Compiled(), recipe)
        assert store.save(k, files, tct.fingerprint, "eval", (), variant)
        again = taot.AotStore(str(tmp_path / "aot"))
        ent = [e for e in again.entries_for(tct.fingerprint)]
        assert [(e["tag"], e["static"], e["asig"]) for e in ent] == \
            [("eval", (), variant)], "the variant key survives JSON"
        got = again.load(k)
        meta = json.loads(got[clause_triton.VARIANT_META])
        assert got[meta["source"]].decode() == src
        assert {n: got[n] for n in group} == group
        assert clause_triton.source_name(src) in got
        checked += 1
    assert checked == 3


# ------------------- the acquisition against a stand-in of Triton's cache


class _Manager:
    """Triton's FileCacheManager as Triton 3.6 has it: one directory per
    kernel hash (base32) under TRITON_CACHE_DIR, read when it is made;
    put() writes a file, put_group() the group's index, get_group() the
    index's files that exist."""

    def __init__(self, h):
        import base64
        import json

        self._json = json
        name = base64.b32encode(bytes.fromhex(h)).decode().rstrip("=")
        self.cache_dir = os.path.join(taot.triton_cache_dir(), name)
        os.makedirs(self.cache_dir, exist_ok=True)

    def put(self, data, filename, binary=True):
        path = os.path.join(self.cache_dir, filename)
        with open(path, "wb" if isinstance(data, bytes) else "w") as f:
            f.write(data)
        return path

    def put_group(self, filename, group):
        return self.put(self._json.dumps({"child_paths": group}),
                        f"__grp__{filename}")

    def get_group(self, filename):
        path = os.path.join(self.cache_dir, f"__grp__{filename}")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            child = self._json.load(f)["child_paths"]
        return {c: p for c, p in child.items() if os.path.exists(p)}


class _Compiled:
    def __init__(self, h):
        self.hash = h
        self.handles = 0

    def _init_handles(self):
        self.handles += 1


class _JIT:
    """A stand-in JIT function with Triton's two caches: the in-memory
    one (device_caches[0][0], by specialization) and the disk cache, where
    a compile writes the group and a load reads it. Its specialization is
    the dtypes, 16-byte alignments and integer values of the arguments
    and the meta-parameters, as Triton's is."""

    def __init__(self, src):
        self.src = src
        self.device_caches = {0: ({},)}
        self.compiles = 0
        self.fail = False

    def _get(self, args, meta):
        import hashlib

        spec = [(str(a.dtype), a.data_ptr() % 16 == 0)
                if hasattr(a, "data_ptr") else repr(a) for a in args]
        h = hashlib.sha256(repr((self.src, spec, sorted(meta.items())))
                           .encode()).hexdigest()
        mem = self.device_caches[0][0]
        if h not in mem:
            if self.fail:
                raise RuntimeError("stand-in compile failed")
            mgr = _Manager(h)
            if mgr.get_group("clause_kernel.json") is None:
                self.compiles += 1
                mgr.put_group("clause_kernel.json", {
                    "clause_kernel.json": mgr.put(b"{}", "clause_kernel.json"),
                    "clause_kernel.cubin": mgr.put(h.encode(),
                                                   "clause_kernel.cubin"),
                    "clause_kernel.ptx": mgr.put(b"ptx", "clause_kernel.ptx")})
            mem[h] = _Compiled(h)
        return mem[h]

    def __getitem__(self, grid):
        return lambda *args, **meta: self._get(args, meta)

    def warmup(self, *args, grid, **meta):
        return self._get(args, meta)


def test_k2_acquisition_sources_with_a_stand_in_triton(tmp_path, monkeypatch):
    """clause_triton's acquisition and preload against a stand-in of
    Triton's JIT function and file cache (the CPU has no Triton): a
    variant compiled in a first process counts "fresh" and is saved with
    its source; a second process with an empty Triton cache preloads it
    ("aot", no compile: Triton's hash matches the installed group) and
    launches it without compiling; a variant the store lacks raises
    WouldCompile under no_inline_compile before anything compiles, and
    otherwise counts "cache" when Triton's disk cache held its group
    before the launch; a failing launch counts "error"."""
    import torch

    from gatekeeper_tpu_torch.kernels import build as kernel_build

    monkeypatch.setattr(clause_triton, "_cache_manager", _Manager)
    jits: dict = {}

    def load_kernel(src):
        return jits.setdefault(src, _JIT(src))

    monkeypatch.setattr(clause_triton, "_load_kernel", load_kernel)
    src = "def clause_kernel(a0, out, N):\n    pass\n"
    meta = dict(BLOCK_N=8, BC=32, WPP=1, num_warps=4)
    feats = torch.zeros(64, dtype=torch.int32)
    args = (feats[1:], torch.zeros(64, dtype=torch.int8), 300, 5,
            float("nan"))
    variant = (("kernel-key",), 300)

    def entry():
        with clause_triton._lock:
            kernel = clause_triton._load_kernel(src)
            return clause_triton._Entry(kernel, src, (8, 32, 1, 4), 0)

    def counts_of(store):
        st = store.stats_snapshot()
        return {k: st[k] for k in ("aot", "cache", "fresh", "error")}

    # the first process: a fresh compile, saved to the store
    monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path / "triton-a"))
    store = taot.AotStore(str(tmp_path / "aot"))
    aot = (store, "fp-1", KIND)
    ent = entry()
    mine = kernel_build.thread_compiles()
    clause_triton._run(ent, (38, 1), *args, variant=variant, aot=aot,
                       **meta)
    clause_triton._run(ent, (38, 1), *args, variant=variant, aot=aot,
                       **meta)
    assert counts_of(store) == {"aot": 0, "cache": 0, "fresh": 1,
                                "error": 0}
    assert ent.kernel.compiles == 1
    assert kernel_build.thread_compiles() == mine + 1
    k = store.entry_key("fp-1", "eval", (), variant)
    saved = store.load(k)
    assert sorted(saved) == sorted(
        [*clause_triton.GROUP_FILES, clause_triton.source_name(src),
         clause_triton.VARIANT_META]), "the cubin and JSON, not the PTX"
    vmeta = json.loads(saved[clause_triton.VARIANT_META])
    assert saved[vmeta["source"]].decode() == src
    assert vmeta["warmup"]["args"][:3] == [["t", "int32", False],
                                          ["t", "int8", True], ["i", 300]]

    # a second process: an empty Triton cache and fresh JIT functions
    jits.clear()
    monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path / "triton-b"))
    store2 = taot.AotStore(str(tmp_path / "aot"))
    aot2 = (store2, "fp-1", KIND)
    mine = kernel_build.thread_compiles()
    assert clause_triton.preload(store2, k, variant, KIND, device="cpu")
    ent2 = entry()
    assert ent2.kernel.compiles == 0
    compiled = next(iter(ent2.kernel.device_caches[0][0].values()))
    assert compiled.handles == 1, "module and launcher loaded at preload"
    with taot.no_inline_compile():
        clause_triton._run(ent2, (38, 1), *args, variant=variant,
                           aot=aot2, **meta)
    assert ent2.kernel.compiles == 0
    assert kernel_build.thread_compiles() == mine
    assert counts_of(store2) == {"aot": 1, "cache": 0, "fresh": 0,
                                 "error": 0}
    assert [e["source"] for e in store2.events_for(KIND)] == ["aot"]

    # a variant the store lacks: WouldCompile under the guard, before
    # any compile; Triton's disk cache (process one's) then answers it
    other = (("kernel-key",), 301)
    args301 = args[:2] + (301,) + args[3:]
    with taot.no_inline_compile():
        with pytest.raises(taot.WouldCompile):
            clause_triton._run(ent2, (38, 1), *args301, variant=other,
                               aot=aot2, **meta)
    assert ent2.kernel.compiles == 0
    monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path / "triton-a"))
    jits.clear()
    ent3 = entry()
    clause_triton._run(ent3, (38, 1), *args, variant=variant,
                       aot=(store2, "fp-2", KIND), **meta)
    assert ent3.kernel.compiles == 0
    assert counts_of(store2)["cache"] == 1
    assert store2.has(store2.entry_key("fp-2", "eval", (), variant))

    # a failing launch counts an error and raises
    ent3.kernel.fail = True
    with pytest.raises(RuntimeError):
        clause_triton._run(ent3, (38, 1), *args301, variant=other,
                           aot=(store2, "fp-2", KIND), **meta)
    assert counts_of(store2)["error"] == 1


def test_k2_store_saves_the_launched_variant_under_an_unlocked_launch(
        tmp_path, monkeypatch):
    """A compiling launch through the program store saves the variant
    it launched: another variant's launch, which takes no lock, running
    between the compile and the save (here while the recipe is taken)
    must not put its group and hash under the compiling variant's key."""
    import torch

    monkeypatch.setattr(clause_triton, "_cache_manager", _Manager)
    jits: dict = {}
    monkeypatch.setattr(clause_triton, "_load_kernel",
                        lambda src: jits.setdefault(src, _JIT(src)))
    monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path / "triton"))
    src = "def clause_kernel(a0, out, N):\n    pass\n"
    meta = dict(BLOCK_N=8, BC=32, WPP=1, num_warps=4)
    feats = torch.zeros(64, dtype=torch.int32)
    store = taot.AotStore(str(tmp_path / "aot"))
    aot = (store, "fp-1", KIND)
    with clause_triton._lock:
        ent = clause_triton._Entry(clause_triton._load_kernel(src), src,
                                   (8, 32, 1, 4), 0)

    def args(rows):
        return (feats, rows, float("nan"))

    warm, new = (("kernel-key",), 300), (("kernel-key",), 301)
    clause_triton._run(ent, (38, 1), *args(300), variant=warm, aot=aot,
                       **meta)
    warm_hash = ent.compiled.hash
    recipe = clause_triton._recipe
    interleaved = []

    def interleaving(*a, **k):
        if not interleaved:
            other = threading.Thread(
                target=clause_triton._run, args=(ent, (38, 1), *args(300)),
                kwargs=dict(variant=warm, aot=aot, **meta))
            other.start()
            other.join(10)
            interleaved.append(not other.is_alive())
        return recipe(*a, **k)

    monkeypatch.setattr(clause_triton, "_recipe", interleaving)
    clause_triton._run(ent, (38, 1), *args(301), variant=new, aot=aot,
                       **meta)
    assert interleaved == [True]
    assert ent.kernel.compiles == 2
    (new_hash,) = {c.hash for c in ent.kernel.device_caches[0][0].values()
                   } - {warm_hash}
    for variant, want in ((warm, warm_hash), (new, new_hash)):
        saved = store.load(store.entry_key("fp-1", "eval", (), variant))
        vmeta = json.loads(saved[clause_triton.VARIANT_META])
        assert vmeta["hash"] == want
        assert saved["clause_kernel.cubin"] == want.encode()
    assert clause_triton._launched(ent.kernel)[(new, (True,))].hash == \
        new_hash


def test_store_under_concurrent_writers(tmp_path):
    """The prewarm and warm threads of every kind write one store at once:
    32 threads, each saving 8 groups (half of them keys another thread
    saves too) and recording 8 sweep signatures, with a short switch
    interval. No entry or sig is lost or doubled, in memory or in the
    manifest a reload reads."""
    import sys

    store = taot.AotStore(str(tmp_path / "aot"))
    gate = threading.Event()

    def work(t):
        gate.wait(10)
        for i in range(8):
            k = t // 2 * 8 + i if i % 2 else t * 8 + i  # odd i: shared
            fp = f"fp-{k % 3}"
            store.save(f"{k:040d}", {"clause_kernel.cubin": bytes([k % 251])},
                       fp, "eval", (), (k,))
            store.record_sig(fp, ("sig", t, i))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(32)]
        for t in threads:
            t.start()
        gate.set()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    keys = {t // 2 * 8 + i if i % 2 else t * 8 + i
            for t in range(32) for i in range(8)}
    assert store.programs_count() == len(keys)
    again = taot.AotStore(str(tmp_path / "aot"))
    for st in (store, again):
        got = sorted(e["asig"][0] for fp in ("fp-0", "fp-1", "fp-2")
                     for e in st.entries_for(fp))
        assert got == sorted(keys)
        assert sum(len(st.sigs_for(f"fp-{j}")) for j in range(3)) == 32 * 8
    assert sorted(n for n in os.listdir(store.dir)
                  if n != store.MANIFEST) == sorted(f"{k:040d}" for k in keys)
