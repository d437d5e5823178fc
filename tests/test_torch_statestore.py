"""The port's state store against the JAX package's.

The statestore cases of tests/test_warm_restart.py (:137-235), each run
against both packages' `control.statestore.StateStore`; the files either
package writes for the same payloads, equal byte for byte once the save
time is dropped from the header; the sections both packages' Runtimes
write on SIGTERM drain for the same cluster (the JSON sections equal
without the save time, the inventory blob's payload equal, the `rows`
blob's arrays equal); and the port's copy of tests/test_coldstart.py's
warm-cache prepack case (:412), whose summary keys must equal the
reference's (on the CPU the port stores no kernel variant:
`programs_stored` is 0).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest

from .test_torch_warm_restart import (  # noqa: F401 (the autouse fixture)
    JAX,
    NEED_OWNER_CONSTRAINT,
    TORCH,
    _hard_timeout_and_clean_faults,
    _metric_value,
    _mk_runtime,
    _seed_cluster,
)

PKG = pytest.mark.parametrize("ns", [TORCH, JAX], ids=["torch", "jax"])


# ----------------------------------------- tests/test_warm_restart.py


@PKG
def test_statestore_roundtrip_json_and_blob(ns, tmp_path):
    store = ns.statestore.StateStore(str(tmp_path))
    assert store.save("vocab", {"strings": ["a", "b"]})
    assert store.load("vocab") == {"strings": ["a", "b"]}
    payload = {"tree": {"t": {"cluster": {"v1": {"Pod": {"x": {"k": 1}}}}}},
               "tracker": {"state": []}}
    assert store.save_blob("inventory", payload)
    assert store.load_blob("inventory") == payload
    assert store.age_s("vocab") is not None
    assert store.age_s("vocab") < 60


@PKG
def test_statestore_blob_pickles_frozen_values(ns, tmp_path):
    # FrozenDict payloads (encoded-rows metadata may carry them) must
    # round-trip the blob path
    store = ns.statestore.StateStore(str(tmp_path))
    fd = ns.values.FrozenDict({"a": (1, 2)})
    assert store.save_blob("rows", {"k": fd})
    out = store.load_blob("rows")
    assert out["k"] == fd
    assert type(out["k"]) is ns.values.FrozenDict


@PKG
def test_statestore_corruption_detected(ns, tmp_path):
    store = ns.statestore.StateStore(str(tmp_path))
    store.save("library", {"templates": [1, 2, 3]})
    path = store.path("library")
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[: len(data) - 5])
    with pytest.raises(ns.statestore.SnapshotError):
        store.load("library")
    # the shared restore protocol maps it to the "fallback" outcome
    before = _metric_value(ns, "gatekeeper_tpu_snapshot_restore_total",
                           outcome="fallback")
    assert ns.statestore.restore_section(store, "library",
                                         lambda p: None) is False
    after = _metric_value(ns, "gatekeeper_tpu_snapshot_restore_total",
                          outcome="fallback")
    assert after == before + 1


@PKG
def test_statestore_schema_skew_and_staleness(ns, tmp_path):
    store = ns.statestore.StateStore(str(tmp_path))
    store.save("vocab", {"strings": []})
    raw = open(store.path("vocab"), "rb").read()
    head, _, body = raw.partition(b"\n")
    header = json.loads(head)
    header["schema"] = 999
    with open(store.path("vocab"), "wb") as f:
        f.write(json.dumps(header).encode() + b"\n" + body)
    with pytest.raises(ns.statestore.SnapshotError):
        store.load("vocab")
    # staleness: a store with a tiny max age rejects an old snapshot
    store2 = ns.statestore.StateStore(str(tmp_path), max_age_s=0.01)
    store2.save("vocab", {"strings": []})
    time.sleep(0.05)
    with pytest.raises(ns.statestore.SnapshotError):
        store2.load("vocab")


@PKG
def test_statestore_missing_is_not_fallback(ns, tmp_path):
    store = ns.statestore.StateStore(str(tmp_path))
    before = _metric_value(ns, "gatekeeper_tpu_snapshot_restore_total",
                           outcome="missing")
    assert ns.statestore.restore_section(store, "nothing",
                                         lambda p: None) is False
    after = _metric_value(ns, "gatekeeper_tpu_snapshot_restore_total",
                          outcome="missing")
    assert after == before + 1


@PKG
def test_fault_io_error_on_save_keeps_previous(ns, tmp_path):
    store = ns.statestore.StateStore(str(tmp_path))
    assert store.save("library", {"v": 1})
    ns.FAULTS.inject("state.snapshot", mode="io-error", count=1)
    assert store.save("library", {"v": 2}) is False
    # previous snapshot intact: atomic write never clobbers on failure
    assert store.load("library") == {"v": 1}


@PKG
def test_fault_corrupt_via_spec_syntax(ns, tmp_path):
    # the production arming path: --fault-injection spec syntax
    ns.FAULTS.configure("state.snapshot:corrupt#1")
    store = ns.statestore.StateStore(str(tmp_path))
    assert store.save("library", {"v": 1})  # save lands, then corrupts
    with pytest.raises(ns.statestore.SnapshotError):
        store.load("library")
    assert ns.FAULTS.fired("state.snapshot") == 1


@PKG
def test_fault_truncate_blob_falls_back(ns, tmp_path):
    store = ns.statestore.StateStore(str(tmp_path))
    ns.FAULTS.inject("state.snapshot", mode="truncate", count=1,
                     match={"op": "save"})
    store.save_blob("inventory", {"tree": {},
                                  "tracker": {"x": list(range(1000))}})
    assert ns.statestore.restore_section(store, "inventory", lambda p: None,
                                         blob=True) is False


# ------------------------------------------------- the files written


def _header_and_body(path: str) -> tuple:
    """A section file's header without its save time, and its body."""
    raw = open(path, "rb").read()
    head, _, body = raw.partition(b"\n")
    header = json.loads(head)
    assert isinstance(header.pop("created"), float)
    return header, body


def _written(ns, tmp_path) -> dict:
    store = ns.statestore.StateStore(str(tmp_path / ns.name))
    store.save("library", {"templates": [{"kind": "X", "rego": "p"}],
                           "constraints": []})
    store.save_blob("inventory", {"tree": {"a": {"b": [1, 2]}},
                                  "tracker": {"rvs": {"x": "7"}}},
                    codec="marshal")
    store.save_blob("rows", {"K": {"n_pad": 8, "buckets": (1, 2)}})
    out = {}
    for name in sorted(os.listdir(store.dir)):
        path = os.path.join(store.dir, name)
        if name.endswith(".json"):
            out[name] = _header_and_body(path)
        else:
            out[name] = open(path, "rb").read()
    return out


def test_statestore_files_equal_the_reference(tmp_path):
    """The same payloads give the same files in both packages: every
    JSON header (schema, section, checksum, codec) and body, and every
    blob, byte for byte; only the save time differs."""
    got, want = _written(TORCH, tmp_path), _written(JAX, tmp_path)
    assert sorted(got) == sorted(want) == [
        "inventory.snapshot.blob", "inventory.snapshot.json",
        "library.snapshot.json", "rows.snapshot.blob",
        "rows.snapshot.json"]
    assert got == want


def _drain_snapshot(ns, tmp_path) -> str:
    """A Runtime on the reference's seeded cluster, its driver's device
    path pinned (so that the encoded rows exist), one sweep, then the
    SIGTERM drain snapshot; returns the state dir."""
    kube = ns.kube.FakeKube()
    state_dir = str(tmp_path / ns.name / "state")
    rt = _mk_runtime(ns, kube, state_dir)
    rt.opa.driver._use_device_for_batch = lambda n: True
    _seed_cluster(kube, n=40, violating=7)
    rt.start()
    rt.manager.drain()
    kube.create(NEED_OWNER_CONSTRAINT)
    rt.manager.drain()
    assert len(rt.audit.audit_once()) == 7
    rt.stop()
    return state_dir


def _same_arrays(a, b, where: str) -> None:
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _same_arrays(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_arrays(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    else:
        assert a == b, where


def test_runtime_drain_snapshot_sections_equal(tmp_path):
    """Both packages' Runtimes write the same state for the same
    cluster: the vocabulary and the library (JSON: header without the
    save time, and body), the inventory (tree and tracker) and the
    encoded rows (every array equal)."""
    dirs = {ns.name: _drain_snapshot(ns, tmp_path) for ns in (TORCH, JAX)}
    files = {name: sorted(f for f in os.listdir(d) if f != "aot")
             for name, d in dirs.items()}
    assert files["torch"] == files["jax"] == [
        "inventory.snapshot.blob", "inventory.snapshot.json",
        "library.snapshot.json", "rows.snapshot.blob", "rows.snapshot.json",
        "vocab.snapshot.json"]
    for name in ("vocab.snapshot.json", "library.snapshot.json"):
        got, want = (_header_and_body(os.path.join(dirs[p], name))
                     for p in ("torch", "jax"))
        assert got == want, name
    stores = {ns.name: ns.statestore.StateStore(dirs[ns.name])
              for ns in (TORCH, JAX)}
    inv = {p: s.load_blob("inventory") for p, s in stores.items()}
    assert inv["torch"] == inv["jax"]
    assert inv["torch"]["tracker"]["state"]
    rows = {p: s.load_blob("rows") for p, s in stores.items()}
    assert sorted(rows["torch"]) == ["K8sNeedOwner"]
    _same_arrays(rows["torch"], rows["jax"], "rows")


# ------------------------------------- tests/test_coldstart.py (:412)


LABEL_KEYS = ["owner", "team", "env", "cost", "tier",
              "zone", "org", "app", "rel", "stage"]


def _labels_client(ns, drv, n, n_cons):
    pol = __import__(f"{ns.main.__name__.split('.')[0]}.policies",
                     fromlist=["load"])
    client = ns.Backend(drv).new_client([ns.Target()])
    client.add_template(pol.load("general/requiredlabels"))
    for k in range(n_cons):
        client.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": "K8sRequiredLabels",
            "metadata": {"name": f"need-{LABEL_KEYS[k]}"},
            "spec": {"parameters": {"labels": [{"key": LABEL_KEYS[k]}]}}})
    for i in range(n):
        labels = {LABEL_KEYS[j]: "x" for j in range(len(LABEL_KEYS))
                  if (i + j) % 3}
        client.add_data({"apiVersion": "v1", "kind": "Namespace",
                         "metadata": {"name": f"ns{i:05d}",
                                      "labels": labels}})
    return client


def _warm_cache(ns, tmp_path, capsys) -> dict:
    import logging as _logging

    drv = ns.driver()
    drv._use_device_for_batch = lambda n: True
    client = _labels_client(ns, drv, 2048, 5)
    client.audit()
    state = str(tmp_path / ns.name / "state")
    store = ns.statestore.StateStore(state)
    store.save("vocab", drv.vocab_snapshot())
    store.save("library", client.snapshot_library())
    store.save_blob("inventory",
                    {"tree": drv.inventory_snapshot() or {},
                     "tracker": {}}, codec="marshal")
    # warm_cache_main is a CLI entrypoint: its glog.setup() flips the
    # "gatekeeper" logger to propagate=False, which would blind caplog
    # for every later in-process test — snapshot and restore
    gklog = _logging.getLogger("gatekeeper")
    saved = (gklog.handlers[:], gklog.propagate, gklog.level)
    try:
        rc = ns.main.warm_cache_main(["--state-dir", state] + ns.device)
    finally:
        gklog.handlers[:], gklog.propagate, gklog.level = saved
    out = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("{")]
    assert rc == 0 and out
    summary = json.loads(out[-1])
    assert summary["restored"]["library"] and summary["objects"] == 2048
    assert os.path.isdir(os.path.join(state, "aot"))
    return summary


def test_warm_cache_cli_prepacks_from_snapshots(tmp_path, capsys):
    """`warm-cache --state-dir D`: restores the vocab/library/inventory
    snapshots, sweeps once inline and stores what it compiled under
    <state-dir>/aot. The port's summary has the reference's keys and
    the same restore outcomes, objects and violations; on the CPU it
    compiles no kernel, so it stores none."""
    got = _warm_cache(TORCH, tmp_path, capsys)
    want = _warm_cache(JAX, tmp_path, capsys)
    assert sorted(got) == sorted(want) == [
        "aot", "audit_s", "compile_cache_enabled", "objects",
        "programs_stored", "restored", "violations"]
    for key in ("restored", "objects", "violations"):
        assert got[key] == want[key], key
    assert want["programs_stored"] >= 1
    assert got["programs_stored"] == 0
    assert sorted(got["aot"]) == sorted(want["aot"])
