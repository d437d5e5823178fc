#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gatekeeper_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card: nvidia-smi's name and power limit, torch's device name;
  2. the build: K1 (csrc/pair_compact.cu) with nvcc, its ptxas summary,
     and Triton for K2;
  3. K1 against its plain version, bit-exact, at the audit's slab shape
     [57344, 16] and the mono shape [131072, 16], bit densities 0, 1e-4
     and 1e-2, with a row range, a slab-overlap start, c < 32W and a
     count above the capacity;
  4. K2 against its plain version, bit-exact: the requiredlabels flagship
     at config-4 size (100,000 objects x 500 constraints) and each of the
     21 device-compiled shipped templates over the fleet-scan corpus;
  5. the main path, audit: Client + TorchDriver() on config 4 must
     return exactly 81,346 results (first and steady wall clock), and a
     2,000-object subset must equal the interpreter (RegoDriver);
  6. the main path, review batches: the 21 compiled templates over 512
     corpus manifests (dense branch) and 8,192 (sparse branch, K1) must
     equal the interpreter per review, with no kind demoted.
The kernels' launch counters are zeroed just before phase 5 and read
just after phase 6: every kernel must have launched on the main path.

Output, last lines: one JSON object per kernel run ({"kernels": [...]}),
the card's name and power limit as nvidia-smi prints them, and
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
there is no CUDA card or when the package is not beside this script.
Times come from CUDA events after a warm-up; bounds use the H100 SXM's
published 3.35 TB/s and 67 TFLOP/s (FP32, no tensor cores).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12  # FP32/INT32 CUDA cores, no tensor cores
# config 4 (BASELINE.md): 500 requiredlabels constraints x 100,000
# Namespaces; BENCH_r07 counted 81,346 violating pairs
CONFIG4 = (100_000, 500)
CONFIG4_RESULTS = 81346
SLAB = 57344            # the audit's slab at config 4 (_sweep_slab)
K1_ROWS = (SLAB, 131072)  # slab and mono sweep shapes
SUBSET = 2000           # objects in the interpreter cross-check
BATCHES = ((512, "dense"), (8192, "sparse"))


class Fail(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Fail(what)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / PEAK_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def pack_bits(bits):
    """bool [R, 32W] -> int32 words [R, W] (uint32 bits)."""
    import torch

    r, n = bits.shape
    w = n // 32
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits.reshape(r, w, 32).to(torch.int64) << shifts).sum(-1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32).contiguous()


def unpack_masked(words, r_begin, r_end, c):
    """The bool matrix K1 compacts (for the torch.nonzero yardstick)."""
    import torch

    r, w = words.shape
    dev = words.device
    u = words.to(torch.int64) & 0xFFFFFFFF
    bits = ((u[:, :, None] >> torch.arange(32, device=dev)) & 1).reshape(
        r, w * 32).bool()
    rows = torch.arange(r, device=dev)
    bits &= ((rows >= r_begin) & (rows < r_end))[:, None]
    bits &= (torch.arange(w * 32, device=dev) < c)[None, :]
    return bits


def corpus(n: int) -> list[dict]:
    """n manifests of the fleet-scan corpus (its JSONL form), cycled
    with renamed copies past its 2,000 objects."""
    path = os.path.join(ROOT, "tests", "fixtures", "fleet_scan",
                        "inventory.jsonl")
    with open(path) as f:
        base = [json.loads(line) for line in f]
    out = []
    for i in range(n):
        o = json.loads(json.dumps(base[i % len(base)]))
        if i >= len(base):
            o["metadata"]["name"] += f"-r{i // len(base)}"
        out.append(o)
    return out


def library_client(driver, compiled_only: bool):
    from gatekeeper_tpu_torch import policies
    from gatekeeper_tpu_torch.client import Backend
    from gatekeeper_tpu_torch.parallel.workload import (
        GENERAL_CONSTRAINTS, PSP_CONSTRAINTS)
    from gatekeeper_tpu_torch.target import K8sValidationTarget

    joins = {"general/uniqueingresshost": "K8sUniqueIngressHost",
             "general/uniqueserviceselector": "K8sUniqueServiceSelector"}
    client = Backend(driver).new_client([K8sValidationTarget()])
    for name in policies.names():
        if compiled_only and name in joins:
            continue
        client.add_template(policies.load(name))
    for kind, cname, params in GENERAL_CONSTRAINTS + PSP_CONSTRAINTS:
        if compiled_only and kind in joins.values():
            continue
        client.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind, "metadata": {"name": cname},
            "spec": ({"parameters": params} if params else {})})
    return client


def result_key(results):
    return [(r.msg, r.constraint["metadata"]["name"],
             (r.resource or {}).get("metadata", {}).get("name"),
             r.enforcement_action) for r in results]


def phase_build(report: dict) -> None:
    from gatekeeper_tpu_torch.kernels import pair_compact as k1

    t0 = time.perf_counter()
    ptxas = k1.build()
    log(f"[build] K1 nvcc sm_90a: {time.perf_counter() - t0:.2f} s")
    for line in ptxas.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build]   {line.strip()}")
    import triton

    log(f"[build] triton {triton.__version__} imported (K2 compiles per "
        "template at first launch)")
    report["triton"] = triton.__version__


def phase_k1(dev) -> None:
    import torch

    from gatekeeper_tpu_torch.kernels.pair_compact import (
        pair_compact, pair_compact_plain)

    g = torch.Generator(device=dev).manual_seed(0)
    for rows in K1_ROWS:
        for dens in (0.0, 1e-4, 1e-2):
            bits = torch.rand((rows, 512), device=dev, generator=g) < dens
            words = pack_bits(bits)
            cases = [(0, rows, 0, 512, 1 << 17),
                     (rows // 7, rows - 3, 40960, 500, 1 << 17)]
            n = int(bits.sum())
            if n > 1:
                cases.append((0, rows, 0, 512, max(1, n // 3)))
            for rb, re_, row0, c, pcap in cases:
                got = pair_compact(words, rb, re_, row0, c, pcap)
                ref = pair_compact_plain(words, rb, re_, row0, c, pcap)
                torch.cuda.synchronize()
                count = int(ref[0, 0])
                check(torch.equal(got, ref),
                      f"K1 != plain at [{rows}, 16] density {dens} "
                      f"rows [{rb}, {re_}) row0 {row0} c {c} pcap {pcap}")
                log(f"[K1] [{rows}, 16] density {dens:g} rows [{rb}, {re_})"
                    f" row0 {row0} c {c} pcap {pcap}: {count} pairs"
                    f"{' (> pcap)' if count > pcap else ''}, bit-exact")
        kms = cuda_ms(lambda: pair_compact(words, 0, rows, 0, 512, 1 << 17))
        pms = cuda_ms(lambda: pair_compact_plain(words, 0, rows, 0, 512,
                                                 1 << 17), reps=5)
        flat = unpack_masked(words, 0, rows, 512)
        lms = cuda_ms(lambda: torch.nonzero(flat), reps=5)
        log(f"[K1] [{rows}, 16] density 1e-2: kernel {kms:.4f} ms, plain "
            f"{pms:.4f} ms, torch.nonzero {lms:.4f} ms")


def phase_k2(dev, report: dict) -> None:
    import torch

    from gatekeeper_tpu_torch.ir import TorchDriver
    from gatekeeper_tpu_torch.ir.carry import tree_from_numpy
    from gatekeeper_tpu_torch.kernels import clause_triton
    from gatekeeper_tpu_torch.kernels.clause import (
        clause_words, clause_words_plain)
    from gatekeeper_tpu_torch.kernels.pair_compact import (
        pair_compact, pair_compact_plain)
    from gatekeeper_tpu_torch.parallel.workload import build_eval_setup
    from gatekeeper_tpu_torch.target import K8sValidationTarget

    t0 = time.perf_counter()
    n_obj, n_con = CONFIG4
    setup = build_eval_setup(n_obj, n_con, device=dev.type)
    ct = setup[1]
    feats, params, table, derived = (tree_from_numpy(x, dev)
                                     for x in setup[2:6])
    log(f"[K2] flagship inputs ({n_obj} objects x {n_con} constraints): "
        f"{time.perf_counter() - t0:.1f} s host")
    cache: dict = {}
    t0 = time.perf_counter()
    words = clause_words(ct.plans, feats, params, table, derived,
                         cache=cache)
    torch.cuda.synchronize()
    log(f"[K2] flagship kernel first launch (Triton compile): "
        f"{time.perf_counter() - t0:.1f} s")
    ref = clause_words_plain(ct.plans, feats, params, table, derived)
    torch.cuda.synchronize()
    check(torch.equal(words, ref), "K2 != plain on the config-4 flagship")
    err = int((words.long() - ref.long()).abs().max())
    log(f"[K2] flagship words {tuple(words.shape)}: bit-exact "
        f"({int(torch.count_nonzero(words))} nonzero words)")
    # time at the audit's slab shape: 57,344 rows of the same features
    slab = SLAB
    sub = {s: {k: v[:slab] for k, v in a.items()} for s, a in feats.items()}
    kms = cuda_ms(lambda: clause_words(ct.plans, sub, params, table,
                                       derived, cache=cache))
    pms = cuda_ms(lambda: clause_words_plain(ct.plans, sub, params, table,
                                             derived), reps=3, warmup=1)
    work = clause_triton.cost(ct.plans, sub, params, table, derived)
    bms, by = bound_ms(work["bytes"], work["ops"])
    log(f"[K2] flagship slab [{slab}, {words.shape[1]}]: kernel {kms:.4f} ms, plain "
        f"{pms:.4f} ms, bound {bms:.4f} ms ({by}: {work['bytes']} B, "
        f"{work['ops']} ops)")
    report["K2"] = {"max_abs_err": err, "ms": kms, "plain_ms": pms,
                    "bound_ms": bms, "bound_by": by, "library_ms": None}
    # K1 on the real slab verdicts, the audit's capacity ratchet
    sw = words[:slab].contiguous()
    count = int(pair_compact_plain(sw, 0, slab, 0, n_con, 1)[0, 0])
    pcap = 1 << max(8, (count - 1).bit_length())
    got = pair_compact(sw, 0, slab, 0, n_con, pcap)
    ref1 = pair_compact_plain(sw, 0, slab, 0, n_con, pcap)
    torch.cuda.synchronize()
    check(torch.equal(got, ref1), "K1 != plain on the flagship slab")
    err1 = int((got.long() - ref1.long()).abs().max())
    kms = cuda_ms(lambda: pair_compact(sw, 0, slab, 0, n_con, pcap))
    pms = cuda_ms(lambda: pair_compact_plain(sw, 0, slab, 0, n_con, pcap),
                  reps=5)
    flat = unpack_masked(sw, 0, slab, n_con)
    lms = cuda_ms(lambda: torch.nonzero(flat), reps=5)
    nbytes = sw.numel() * 4 + (pcap + 1) * 2 * 4
    ops = 2 * 2 * sw.numel() + 4 * count  # mask+popcount, twice; per pair
    bms, by = bound_ms(nbytes, ops)
    log(f"[K1] flagship slab [{slab}, {sw.shape[1]}], {count} pairs, pcap {pcap}: "
        f"kernel {kms:.4f} ms, plain {pms:.4f} ms, torch.nonzero "
        f"{lms:.4f} ms, bound {bms:.5f} ms ({by})")
    report["K1"] = {"max_abs_err": err1, "ms": kms, "plain_ms": pms,
                    "bound_ms": bms, "bound_by": by, "library_ms": lms}
    del feats, params, table, derived, words, ref, sub, flat

    # every device-compiled shipped template over the corpus
    drv = TorchDriver()
    library_client(drv, compiled_only=True)
    target = K8sValidationTarget()
    reviews = [target.handle_review(o)[1] for o in corpus(2000)]
    cons = drv._constraints("admission.k8s.gatekeeper.sh")
    kinds = drv.compiled_kinds()
    check(len(kinds) == 21, f"expected 21 compiled kinds, got {len(kinds)}")
    for kind in kinds:
        kct = drv.compiled_for(kind)
        kc = [c for c in cons if c["kind"] == kind]
        ins = drv._prepare_eval(kct, kind, reviews, kc, None)
        t0 = time.perf_counter()
        got = clause_words(kct.plans, *ins, cache={})
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        ref = clause_words_plain(kct.plans, *ins)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"K2 != plain for {kind}")
        cache: dict = {}
        kms = cuda_ms(lambda: clause_words(kct.plans, *ins, cache=cache),
                      reps=10)
        log(f"[K2] {kind}: words {tuple(got.shape)} bit-exact "
            f"({int(torch.count_nonzero(got))} nonzero), first launch "
            f"{first:.2f} s, kernel {kms:.4f} ms")


def phase_audit(dev, report: dict) -> None:
    from gatekeeper_tpu_torch.client import Backend, RegoDriver
    from gatekeeper_tpu_torch.ir import TorchDriver
    from gatekeeper_tpu_torch.kernels.clause import clause_words
    from gatekeeper_tpu_torch.kernels.pair_compact import pair_compact
    from gatekeeper_tpu_torch.parallel.workload import (
        REQUIRED_LABELS_TEMPLATE, synth_constraints, synth_objects)
    from gatekeeper_tpu_torch.target import K8sValidationTarget

    def flagship(driver, n):
        client = Backend(driver).new_client([K8sValidationTarget()])
        client.add_template(REQUIRED_LABELS_TEMPLATE)
        for c in synth_constraints(CONFIG4[1], seed=1):
            client.add_constraint(c)
        for o in synth_objects(n, violate_frac=0.01, seed=0):
            client.add_data(o)
        return client

    t0 = time.perf_counter()
    drv = TorchDriver()
    client = flagship(drv, CONFIG4[0])
    log(f"[audit] config 4 ingest ({CONFIG4[1]} constraints, {CONFIG4[0]} "
        "objects): "
        f"{time.perf_counter() - t0:.1f} s")
    before = clause_words.launches, pair_compact.launches
    t0 = time.perf_counter()
    res = client.audit().results()
    first = time.perf_counter() - t0
    check(len(res) == CONFIG4_RESULTS,
          f"config-4 audit returned {len(res)} results, want "
          f"{CONFIG4_RESULTS}")
    t0 = time.perf_counter()
    res2 = client.audit().results()
    steady = time.perf_counter() - t0
    check(result_key(res2) == result_key(res), "steady audit differs")
    k2 = clause_words.launches - before[0]
    k1 = pair_compact.launches - before[1]
    check(k2 > 0 and k1 > 0, f"audit launches: K2 {k2}, K1 {k1}")
    counts = drv.eval_counts()
    check(counts.get(("K8sRequiredLabels", "device"), 0) >= 2,
          f"requiredlabels did not evaluate on the device: {counts}")
    log(f"[audit] config 4: {len(res)} results; first audit {first:.3f} s,"
        f" steady audit {steady:.3f} s (path {drv.last_audit_path}); "
        f"launches K2 {k2}, K1 {k1}")
    report["audit"] = {"results": len(res), "first_s": first,
                       "steady_s": steady}

    sub_t = flagship(TorchDriver(), SUBSET)
    sub_r = flagship(RegoDriver(), SUBSET)
    got = result_key(sub_t.audit().results())
    want = result_key(sub_r.audit().results())
    check(got == want, f"{SUBSET}-object audit differs from the "
          "interpreter")
    log(f"[audit] {SUBSET}-object subset: {len(got)} results equal the "
        "interpreter's (msg, constraint, resource, action, order)")


def phase_batches(dev, report: dict) -> None:
    from gatekeeper_tpu_torch.client import RegoDriver
    from gatekeeper_tpu_torch.ir import TorchDriver
    from gatekeeper_tpu_torch.kernels.clause import clause_words
    from gatekeeper_tpu_torch.kernels.pair_compact import pair_compact

    drv = TorchDriver()
    client = library_client(drv, compiled_only=True)
    oracle = library_client(RegoDriver(), compiled_only=True)
    for n, branch in BATCHES:
        objs = corpus(n)
        before = clause_words.launches, pair_compact.launches
        t0 = time.perf_counter()
        got = client.review_batch(objs)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = client.review_batch(objs)
        steady = time.perf_counter() - t0
        want = oracle.review_batch(objs)
        gk = [result_key(r.results()) for r in got]
        check(gk == [result_key(r.results()) for r in want],
              f"review batch of {n} differs from the interpreter")
        check(gk == [result_key(r.results()) for r in again],
              f"repeated review batch of {n} differs")
        k2 = clause_words.launches - before[0]
        k1 = pair_compact.launches - before[1]
        check(k2 > 0, f"batch of {n}: K2 never launched")
        if branch == "sparse":
            check(k1 > 0, f"batch of {n}: K1 never launched")
        log(f"[batch] {n} manifests ({branch}): "
            f"{sum(len(k) for k in gk)} results equal the interpreter; "
            f"first {first:.3f} s, steady {steady:.3f} s; launches K2 {k2},"
            f" K1 {k1}")
        report[f"batch_{n}"] = {"first_s": first, "steady_s": steady}
    check(drv.fallback_reasons() == {}, "a compiled kind fell back")
    demoted = [k for k in drv.compiled_kinds()
               if drv._compiled.get(k, True) is None]
    check(not demoted, f"demoted kinds: {demoted}")
    counts = drv.eval_counts()
    missing = [k for k in drv.compiled_kinds()
               if counts.get((k, "interp"), 0)]
    check(not missing, f"kinds served by the interpreter: {missing}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import gatekeeper_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    from gatekeeper_tpu_torch.kernels.clause import clause_words
    from gatekeeper_tpu_torch.kernels.pair_compact import pair_compact

    t_all = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    log(smi_line)
    kind = torch.cuda.get_device_name(0)
    log(f"[card] torch {torch.__version__} (CUDA {torch.version.cuda}) on "
        f"{kind}, {torch.cuda.device_count()} visible")
    dev = torch.device("cuda")
    report: dict = {}
    try:
        phase_build(report)
        t0 = time.perf_counter()
        phase_k1(dev)
        log(f"[K1] phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_k2(dev, report)
        log(f"[K2] phase {time.perf_counter() - t0:.1f} s")
        # the main path: counts from 0, driven, read just after
        clause_words.launches = 0
        pair_compact.launches = 0
        t0 = time.perf_counter()
        phase_audit(dev, report)
        phase_batches(dev, report)
        launches = {"K1": pair_compact.launches, "K2": clause_words.launches}
        log(f"[main] audit + batches {time.perf_counter() - t0:.1f} s; "
            f"launches {launches}")
        check(all(v > 0 for v in launches.values()),
              f"a kernel of the main path never launched: {launches}")
    except Fail as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [
        dict(name="K1 pair_compact", route="cuda",
             source="gatekeeper_tpu_torch/csrc/pair_compact.cu",
             replaces="gatekeeper_tpu/ir/evaljax.py:667",
             launches=launches["K1"], **report["K1"]),
        dict(name="K2 clause_words", route="triton",
             source="gatekeeper_tpu_torch/kernels/clause_triton.py",
             replaces="gatekeeper_tpu/ir/evaljax.py:905",
             launches=launches["K2"], **report["K2"]),
    ]
    log(f"[done] {time.perf_counter() - t_all:.1f} s; audit "
        f"{json.dumps(report['audit'])}")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
