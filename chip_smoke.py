#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gatekeeper_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card: nvidia-smi's name and power limit, torch's device name;
  2. the build: K1 (csrc/pair_compact.cu), K3 (csrc/regex_scan.cu), K4
     (csrc/join_member.cu) and K5 (csrc/rows_update.cu), one nvcc each,
     started together, with their ptxas summaries, and Triton for K2;
  3. K1 against its plain version, bit-exact, at the audit's slab shape
     [57344, 16] and the mono shape [131072, 16], bit densities 0, 1e-4
     and 1e-2, with a row range, a slab-overlap start, c < 32W and a
     count above the capacity;
  4. K2 against its plain version, bit-exact: the requiredlabels flagship
     at config-4 size (100,000 objects x 500 constraints) and each of the
     21 device-compiled shipped templates over the fleet-scan corpus; at
     the flagship slab its bound from clause_work (bytes and pair-trips,
     counted from the IR and the shapes), the emitter's own op count
     (emitted_ops, a diagnostic) and the compiled kernel's registers and
     spills; K1 on the slab's words with its launches per call;
  5. K3 against its plain version (and re.search), bit-exact: config 4's
     7 patterns x its vocabulary, the library's regex rows x the corpus
     vocabulary, and a hard set (classes, alternation, anchors, .*, +/?;
     string lengths 0..128); the host re.search rate, the cost of one
     whole scan_device call and the crossover they give;
  6. K4 against its plain version, bit-exact, on a synthetic case with
     every sentinel, G = 2, Kb == len(u) and N not a multiple of 256;
  7. the main path, config-4 audit: Client + TorchDriver() must return
     exactly 81,346 results (first audit on the card, steady audit served
     by the delta cache), its 7 regex rows through K3 exactly when they
     reach DEVICE_CROSSOVER, and a 2,000-object subset must equal the
     interpreter (RegoDriver);
  8. the main path, general-library audit: the 7 general templates over
     synth_mixed_objects must return 332 results at 10,000 objects and
     3,319 at 100,000 (the JAX package's counts), the join kinds through
     K4 and never the interpreter, the steady audit delta-served for the
     5 review-pure kinds; at 100,000 a policy edit (GENERAL_EDIT) must
     return the JAX package's count, its full sweep extending the regex
     rows over the join-interned strings through K3 exactly when they
     reach DEVICE_CROSSOVER (the crossover is measured at that window
     first);
  8b. the main path, BENCH config 6's churn audit in the order of the
     port's CHURN_STEPS: the 16 pod-security-policy templates over
     synth_pods_psp(50,000) must return 58,902 results at the first
     audit and the delta-served steady audit; a churn round of 500 pods
     plus a host-ports edit (E1) must return the JAX package's count
     through features patched by K5 (one launch per kind, no
     extraction), every resident leaf then equal to a fresh upload; a
     full re-encode must equal E1; a churn round with the edit undone
     (E2) must return 58,902, patched again; three more churn rounds
     must return 58,902, delta-served, extracting nothing;
  9. the main path, review batches: all 23 shipped templates, with the
     corpus loaded as inventory, over 512 corpus manifests (dense branch)
     and 8,192 (sparse branch, K1) must equal the interpreter per review,
     with no kind demoted or interpreter-served;
 10. a 2,000-object general subset with colliding copies must equal the
     interpreter, with MIN_DEVICE_REVIEWS forced to 1 so that every join
     goes through K4 (after the main path: its launches are not counted);
 11. K3 and K4 against their plain versions at the 100,000-object
     audit's own inputs (K3: the edit round's regex window; K4: both
     join kinds), and the host dict probe against K4 at N = 512, 2,048,
     16,667 and 100,000 (MIN_DEVICE_REVIEWS' break-even);
 12. the churn rounds over a 2,000-pod subset through a second
     TorchDriver and through RegoDriver, equal in every round;
 13. K5 against its plain version at phase 8b's shapes (500 rows into
     every leaf of one kind), its time, and the whole patch path (stage,
     copy, K5) against a full re-upload of the kind's leaves;
 14. K2 against its plain version for each of config 6's 16 kinds at the
     inputs of its first-audit launch (recorded in phase 8b), its time,
     and the first launches' seconds in all.
The kernels' launch counters are zeroed just before phase 7 and read
just after phase 9: every kernel must have launched on the main path.

    python3 chip_smoke.py --kernels [--root DIR] [--tune]

runs K2 and K1 alone (kernels_only: K2 at the flagship slab, the 21
corpus templates and config 6's 16 kinds at their first-audit shapes,
each bit-exact with its first-launch seconds, ms, registers and spills;
K1 on the flagship slab's words), in a Triton cache of its own, and
prints one JSON line per kernel and a summary line. --root imports the
package of another checkout (e.g. the parent commit unpacked with `git
archive` under the gitignored `_checkout/`), so that two commits run on
one card in one call; --tune times every K2 tile of TUNE_CONFIGS.

Output, last lines: one JSON object per kernel run ({"kernels": [...]}),
the card's name and power limit as nvidia-smi prints them, and
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
there is no CUDA card or when the package is not beside this script.
Times come from CUDA events after a warm-up, with the timed calls queued
behind a device-side wait so that they run back to back; bounds use the
H100 SXM's published 3.35 TB/s and 67 TFLOP/s (FP32, no tensor cores).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
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
# BENCH config 2 (bench_configs.py): the general library over
# synth_mixed_objects. 332 is BENCH_r07's count at 10,000 objects; both
# counts are the JAX package's TpuDriver's (tests/torch_reference_counts.py)
GENERAL_RESULTS = {10_000: 332, 100_000: 3319}
# the same audit after GENERAL_EDIT at 100,000 objects (the JAX package's
# count, tests/torch_reference_counts.py)
GENERAL_EDIT_RESULTS = {100_000: 3319}
GENERAL_EDIT = ("K8sContainerLimits", "limits-capped",
                {"cpu": "1", "memory": "1Gi"})
# BENCH config 6 (bench_configs.py config6): PSP library x 50,000 pods,
# 1% churn per round; 58,902 is BENCH_r07's count, the edit rounds' are
# the JAX package's (tests/torch_reference_counts.py --churn 50000)
CONFIG6_PODS = 50_000
CONFIG6_RESULTS = 58902
CONFIG6_EDIT_RESULTS = 62494
CHURN_SUBSET = 2000
JOIN_KINDS = ("K8sUniqueIngressHost", "K8sUniqueServiceSelector")
JOIN_N = (512, 2048, 16_667, 100_000)  # host probe vs K4
TARGET = "admission.k8s.gatekeeper.sh"


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
    # queue the timed calls behind ~0.1 s of device-side wait, so that
    # the events time the card's work and not the host's launch rate (a
    # call that synchronizes inside is timed with its host gaps)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_kernels(fn) -> int | None:
    """CUDA kernels one call of `fn` launches, from torch.profiler (None
    when the profiler records no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if str(getattr(e, "device_type", "")).endswith("CUDA"))
    return n or None


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


def library_constraint(kind: str, name: str, params) -> dict:
    return {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind, "metadata": {"name": name},
            "spec": ({"parameters": params} if params else {})}


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
        client.add_constraint(library_constraint(kind, cname, params))
    return client


def result_key(results):
    return [(r.msg, r.constraint["metadata"]["name"],
             (r.resource or {}).get("metadata", {}).get("name"),
             r.enforcement_action) for r in results]


def phase_build(report: dict) -> None:
    from gatekeeper_tpu_torch.kernels import join_member as k4
    from gatekeeper_tpu_torch.kernels import pair_compact as k1
    from gatekeeper_tpu_torch.kernels import regex_scan as k3
    from gatekeeper_tpu_torch.kernels import rows_update as k5
    from gatekeeper_tpu_torch.kernels.build import build_all

    t0 = time.perf_counter()
    reports = build_all()
    log(f"[build] K1, K3, K4, K5 nvcc sm_90a, in parallel: "
        f"{time.perf_counter() - t0:.2f} s")
    for name, ptxas in reports.items():
        for line in ptxas.splitlines():
            if "Used" in line or "spill" in line or \
                    "Compiling entry" in line:
                log(f"[build]   {name}: {line.strip()}")
    for mod in (k1, k3, k4, k5):
        mod.build()  # load the libraries just built
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


def flagship_inputs(dev) -> tuple:
    """Config 4's requiredlabels program at full size: (build_eval_setup's
    driver, plans, feats, params, table, derived) on `dev`."""
    from gatekeeper_tpu_torch.ir.carry import tree_from_numpy
    from gatekeeper_tpu_torch.parallel.workload import build_eval_setup

    t0 = time.perf_counter()
    n_obj, n_con = CONFIG4
    setup = build_eval_setup(n_obj, n_con, device=dev.type)
    feats, params, table, derived = (tree_from_numpy(x, dev)
                                     for x in setup[2:6])
    log(f"[K2] flagship inputs ({n_obj} objects x {n_con} constraints): "
        f"{time.perf_counter() - t0:.1f} s host")
    return setup[0], setup[1].plans, feats, params, table, derived


def slab_of(feats, rows: int = SLAB) -> dict:
    return {s: {k: v[:rows] for k, v in a.items()} for s, a in feats.items()}


def corpus_k2_inputs() -> tuple:
    """The 21 device-compiled shipped templates over 2,000 corpus
    manifests: (their driver, [(kind, plans, inputs)])."""
    from gatekeeper_tpu_torch.ir import TorchDriver
    from gatekeeper_tpu_torch.target import K8sValidationTarget

    drv = TorchDriver()
    library_client(drv, compiled_only=True)
    target = K8sValidationTarget()
    reviews = [target.handle_review(o)[1] for o in corpus(2000)]
    cons = drv._constraints(TARGET)
    kinds = drv.compiled_kinds()
    check(len(kinds) == 21, f"expected 21 compiled kinds, got {len(kinds)}")
    out = []
    for kind in kinds:
        kct = drv.compiled_for(kind)
        kc = [c for c in cons if c["kind"] == kind]
        out.append((kind, kct.plans,
                    tuple(drv._prepare_eval(kct, kind, reviews, kc, None))))
    return drv, out


def time_k2(what: str, plans, ins, first: float | None = None,
            strict: bool = True) -> dict:
    """One K2 kernel in a cache of its own: the seconds of its first
    launch (generation and Triton's compile, unless the main path took
    them: `first`), bit-exactness against the plain version (fatal when
    `strict`), the kernel's ms and the compiled kernel's registers and
    spills."""
    import torch

    from gatekeeper_tpu_torch.kernels.clause import (
        clause_words, clause_words_plain)

    cache: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = clause_words(plans, *ins, cache=cache)
    torch.cuda.synchronize()
    if first is None:
        first = time.perf_counter() - t0
    ref = clause_words_plain(plans, *ins)
    torch.cuda.synchronize()
    exact = torch.equal(got, ref)
    check(exact or not strict, f"K2 != plain for {what}")
    kms = cuda_ms(lambda: clause_words(plans, *ins, cache=cache), reps=10)
    compiled = getattr(next(iter(cache.values()), None), "compiled", None)
    rec = {"name": what, "words": list(got.shape),
           "nonzero": int(torch.count_nonzero(got)), "first_s": first,
           "ms": kms, "exact": exact,
           "n_regs": getattr(compiled, "n_regs", None),
           "n_spills": getattr(compiled, "n_spills", None)}
    log(f"[K2] {what}: words {tuple(got.shape)} "
        f"{'bit-exact' if exact else 'NOT bit-exact'} ({rec['nonzero']} "
        f"nonzero), first launch {first:.2f} s, kernel {kms:.4f} ms, "
        f"n_regs {rec['n_regs']}, n_spills {rec['n_spills']}")
    return rec


def time_k1_slab(sw, n_con: int) -> dict:
    """K1 on a slab's verdict words at the audit's capacity ratchet,
    against its plain version (fatal), with torch.nonzero's time, the
    byte bound and the device kernels one call launches."""
    import torch

    from gatekeeper_tpu_torch.kernels.pair_compact import (
        pair_compact, pair_compact_plain)

    rows = sw.shape[0]
    count = int(pair_compact_plain(sw, 0, rows, 0, n_con, 1)[0, 0])
    pcap = 1 << max(8, (count - 1).bit_length())
    got = pair_compact(sw, 0, rows, 0, n_con, pcap)
    ref = pair_compact_plain(sw, 0, rows, 0, n_con, pcap)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), "K1 != plain on the flagship slab")
    err = int((got.long() - ref.long()).abs().max())
    kms = cuda_ms(lambda: pair_compact(sw, 0, rows, 0, n_con, pcap))
    pms = cuda_ms(lambda: pair_compact_plain(sw, 0, rows, 0, n_con, pcap),
                  reps=5)
    flat = unpack_masked(sw, 0, rows, n_con)
    lms = cuda_ms(lambda: torch.nonzero(flat), reps=5)
    nbytes = sw.numel() * 4 + (pcap + 1) * 2 * 4
    ops = 2 * 2 * sw.numel() + 4 * count  # mask+popcount, twice; per pair
    bms, by = bound_ms(nbytes, ops)
    per_call = device_kernels(lambda: pair_compact(sw, 0, rows, 0, n_con,
                                                   pcap))
    log(f"[K1] flagship slab [{rows}, {sw.shape[1]}], {count} pairs, pcap "
        f"{pcap}: kernel {kms:.4f} ms, plain {pms:.4f} ms, torch.nonzero "
        f"{lms:.4f} ms, bound {bms:.5f} ms ({by}); torch.profiler counted "
        f"{per_call} device kernels a call")
    return {"max_abs_err": err, "ms": kms, "plain_ms": pms, "bound_ms": bms,
            "bound_by": by, "library_ms": lms, "pairs": count,
            "kernels_per_call": per_call}


def phase_k2(dev, report: dict) -> tuple:
    """K2 checks; returns the flagship setup's driver and the library
    driver (their vocabularies and regex rows feed phase K3)."""
    import torch

    from gatekeeper_tpu_torch.kernels import clause_triton
    from gatekeeper_tpu_torch.kernels.clause import (
        clause_words, clause_words_plain, clause_work)
    from gatekeeper_tpu_torch.kernels.pair_compact import pair_compact

    flag_drv, plans, feats, params, table, derived = flagship_inputs(dev)
    n_con = CONFIG4[1]
    t0 = time.perf_counter()
    words = clause_words(plans, feats, params, table, derived, cache={})
    torch.cuda.synchronize()
    log(f"[K2] flagship kernel first launch (Triton compile): "
        f"{time.perf_counter() - t0:.1f} s")
    ref = clause_words_plain(plans, feats, params, table, derived)
    torch.cuda.synchronize()
    check(torch.equal(words, ref), "K2 != plain on the config-4 flagship")
    err = int((words.long() - ref.long()).abs().max())
    log(f"[K2] flagship words {tuple(words.shape)}: bit-exact "
        f"({int(torch.count_nonzero(words))} nonzero words)")
    # time at the audit's slab shape: 57,344 rows of the same features
    sub = slab_of(feats)
    ins = (sub, params, table, derived)
    rec = time_k2(f"flagship slab [{SLAB}] x {n_con}", plans, ins)
    pms = cuda_ms(lambda: clause_words_plain(plans, *ins), reps=3,
                  warmup=1)
    # the bound counts what the data needs (clause_work: the IR and the
    # shapes); the emitter's own count is a design diagnostic
    work = clause_work(plans, *ins)
    emitted = clause_triton.emitted_ops(plans, *ins)
    bms, by = bound_ms(work["bytes"], work["pair_trips"])
    log(f"[K2] flagship slab: plain {pms:.4f} ms, bound {bms:.6f} ms ({by}: "
        f"{work['bytes']} B, {work['pair_trips']} pair-trips); emitted_ops "
        f"{emitted} ({emitted / max(1, work['pair_trips']):.2f} per "
        f"pair-trip); tile (BLOCK_N, BC, WPP, warps) "
        f"{clause_triton.tile(params)}")
    report["K2"] = {"max_abs_err": err, "ms": rec["ms"], "plain_ms": pms,
                    "bound_ms": bms, "bound_by": by, "library_ms": None}
    report["K2_flagship"] = {"emitted_ops": emitted,
                             "pair_trips": work["pair_trips"],
                             "bytes": work["bytes"], "n_regs": rec["n_regs"],
                             "n_spills": rec["n_spills"]}
    # K1 on the real slab verdicts, the audit's capacity ratchet
    k1 = time_k1_slab(words[:SLAB].contiguous(), n_con)
    log(f"[K1] launches per call {pair_compact.kernels_per_call}")
    report["K1"] = {k: k1[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")}
    del feats, params, table, derived, words, ref, sub, ins

    # every device-compiled shipped template over the corpus
    drv, entries = corpus_k2_inputs()
    for kind, kplans, kins in entries:
        time_k2(kind, kplans, kins)
    return flag_drv, drv


def vocab(strtab) -> list[str]:
    """The whole vocabulary, as MatchTables' first window decodes it."""
    return [strtab.string(i) for i in range(len(strtab))]


def k3_args(dfas, bmat, dev) -> tuple:
    """K3's arguments on the card, as scan_device makes them."""
    from gatekeeper_tpu_torch.ir.carry import tree_from_numpy
    from gatekeeper_tpu_torch.ops import regex_nfa

    return tree_from_numpy(regex_nfa.stack_dfas(dfas)
                           + (regex_nfa.trim_bytes(bmat),), dev)


def host_rows(patterns, strings) -> "np.ndarray":
    """The host path's rows: one compiled re.search per (row, string)."""
    import numpy as np

    out = np.zeros((len(patterns), len(strings)), dtype=bool)
    for i, p in enumerate(patterns):
        rx = re.compile(p)
        out[i] = np.fromiter((rx.search(s) is not None for s in strings),
                             dtype=bool, count=len(strings))
    return out


def k3_work(args) -> tuple[float, float]:
    """(bytes, operations) one K3 launch needs on these inputs. A walk
    ends at the NUL pad or at the match sink, so a string's bytes are
    needed only as far as its longest walk over the P patterns (the NUL
    that ends it included); the tables, the accept flags and the output
    count whole. Operations: per DFA step taken 5 integer operations
    (byte extract, NUL test, index multiply-add, table load, sink test),
    and 3 per (pattern, string) for the final accept check."""
    import torch

    table, accept_end, start, matched_id, bmat = args
    P, S, _ = table.shape
    V, L = bmat.shape
    flat = table.reshape(-1)
    p_base = (torch.arange(P, device=table.device) * S)[:, None]
    state = start.long()[:, None].expand(P, V)
    sink = matched_id.long()[:, None]
    live = state != sink  # walks that still read a byte
    string_bytes = 0
    steps = 0
    for t in range(L):
        string_bytes += int(live.any(0).sum())
        byte = bmat[:, t].long()
        active = live & (byte != 0)[None, :]
        steps += int(active.sum())
        nxt = flat[(p_base + state) * 256 + byte[None, :]].long()
        state = torch.where(active, nxt, state)
        live = active & (state != sink)
    nbytes = string_bytes + sum(
        a.numel() * a.element_size() for a in args[:4]) + P * V
    return float(nbytes), float(5 * steps + 3 * P * V)


def k4_work(args, key_pad: int) -> tuple[float, float]:
    """(bytes, operations) one K4 launch needs on these inputs: karr whole
    (each key is tested against KEY_PAD), the u_p entries the real keys'
    lower_bound searches touch, cnt_p at the keys found, sik_p and iks
    only where the identity compare runs (a key found with one holder),
    and one byte out per review. Operations: 3 per search probe (load,
    compare, select) and 3 per real key for the clip, the equality and
    count tests; 2 per identity compare; 1 per key slot for the KEY_PAD
    test. A row's keys after its first firing key count too (the kernel
    skips them; at H = 1 there are none)."""
    import torch

    u_p, cnt_p, sik_p, karr, iks = args
    N, H = karr.shape
    kb, G = u_p.shape[0], sik_p.shape[0]
    rows = torch.arange(N, device=karr.device)[:, None].expand(N, H)
    real = karr != key_pad
    keys, who = karr[real].long(), rows[real]
    lo = torch.zeros_like(keys)
    hi = torch.full_like(keys, kb)
    touched = torch.zeros(kb, dtype=torch.bool, device=u_p.device)
    probes = 0
    while bool((lo < hi).any()):
        going = lo < hi
        probes += int(going.sum())
        mid = lo + ((hi - lo) >> 1)
        touched[mid[going]] = True
        right = going & (u_p[mid.clamp(max=kb - 1)].long() < keys)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(going & ~right, mid, hi)
    pos = lo.clamp(max=kb - 1)
    touched[pos] = True
    found = u_p[pos].long() == keys
    single = found & (cnt_p[pos] < 2)
    nbytes = (karr.numel() + int(touched.sum())
              + int(torch.unique(pos[found]).numel())
              + G * int(torch.unique(pos[single]).numel())
              + G * int(torch.unique(who[single]).numel())) * 4 + N
    ops = 3 * probes + 3 * keys.numel() + int(single.sum()) * 2 * G + N * H
    return float(nbytes), float(ops)


def measure_crossover(what: str, pats: list[str], strings: list[str],
                      dev) -> dict:
    """MatchTables' two ways to build `pats`' rows over a vocab window:
    the host re.search loop, and the device path (scan_prep, then
    scan_device: upload, one K3 launch, download). Break-even = the
    device path's time x the host's evaluations per second. Launches
    made here are not counted."""
    from gatekeeper_tpu_torch.kernels.regex_scan import regex_scan
    from gatekeeper_tpu_torch.ops import regex_nfa

    launches = regex_scan.launches
    dfas = [regex_nfa.try_compile_device(p) for p in pats]
    evals = len(pats) * len(strings)
    host, dev_calls, prep_calls = [], [], []
    for _ in range(3):
        t0 = time.perf_counter()
        host_rows(pats, strings)
        host.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        prep = regex_nfa.scan_prep(strings)
        prep_calls.append(time.perf_counter() - t0)
        check(prep is not None, f"{what}: the window is not scannable")
        regex_nfa.scan_device(dfas, prep[0], dev)
        dev_calls.append(time.perf_counter() - t0)
    regex_scan.launches = launches
    host_s, dev_s, prep_s = (sorted(x)[1] for x in (host, dev_calls,
                                                     prep_calls))
    rate = evals / host_s
    out = {"patterns": len(pats), "strings": len(strings), "evals": evals,
           "host_s": host_s, "host_evals_per_s": rate, "device_s": dev_s,
           "scan_prep_s": prep_s, "break_even_evals": dev_s * rate}
    log(f"[K3] crossover at {what} ({len(pats)} rows x {len(strings)} "
        f"strings = {evals} evaluations): host re.search {host_s:.4f} s "
        f"({rate:.0f}/s), device path {dev_s:.4f} s (scan_prep "
        f"{prep_s:.4f} s of it), medians of 3; break-even "
        f"{dev_s * rate:.0f} evaluations; DEVICE_CROSSOVER "
        f"{regex_nfa.DEVICE_CROSSOVER}")
    return out


def phase_k3(dev, report: dict, flag_drv, lib_drv) -> None:
    import numpy as np
    import torch

    from gatekeeper_tpu_torch.kernels.regex_scan import (
        regex_scan, regex_scan_plain)
    from gatekeeper_tpu_torch.ops import regex_nfa
    from gatekeeper_tpu_torch.ops.strtab import MatchTables
    from tests.torch_kernel_cases import (
        EDGE_LENGTHS, HARD_PATTERNS, hard_vocab)

    def check_k3(what, patterns, strings):
        """K3 against its plain version, and against re.search on every
        string but those the host patches (NUL, \\x01, newline)."""
        dfas = [regex_nfa.try_compile_device(p) for p in patterns]
        check(all(d is not None for d in dfas),
              f"K3 {what}: a pattern is outside the DFA subset")
        prep = regex_nfa.scan_prep(strings)
        check(prep is not None, f"K3 {what}: vocabulary not scannable")
        args = k3_args(dfas, prep[0], dev)
        got = regex_scan(*args)
        ref = regex_scan_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"K3 != plain on {what}")
        keep = np.ones(len(strings), dtype=bool)
        keep[prep[1]] = False
        want = host_rows(patterns, strings)
        check(np.array_equal(got.cpu().numpy()[:, keep], want[:, keep]),
              f"K3 != re.search on {what}")
        log(f"[K3] {what}: {len(patterns)} patterns x {len(strings)} "
            f"strings, L {args[4].shape[1]}, S_max {args[0].shape[1]}: "
            f"bit-exact ({int(want.sum())} matches)")
        return args

    # config 4: the flagship setup's 7 allowedRegex rows x its vocabulary
    pats = [p for op, p in flag_drv.match_tables._patterns
            if op == "re_match"]
    check(len(pats) == 7, f"config 4 has {len(pats)} regex rows, want 7")
    strings = vocab(flag_drv.strtab)
    args = check_k3("config 4", pats, strings)
    kms = cuda_ms(lambda: regex_scan(*args))
    pms = cuda_ms(lambda: regex_scan_plain(*args), reps=3, warmup=1)
    nbytes, ops = k3_work(args)
    bms, by = bound_ms(nbytes, ops)
    log(f"[K3] config 4 [{len(pats)} x {len(strings)}]: kernel {kms:.4f} "
        f"ms, plain {pms:.4f} ms, bound {bms:.5f} ms ({by}: {nbytes:.0f} "
        f"B, {ops:.0f} ops)")
    report["K3_crossover"] = {"config 4": measure_crossover(
        "config 4", pats, strings, dev)}

    # the library's regex and glob rows x the fleet-scan corpus vocabulary
    rows = [(op, p) for op, p in lib_drv.match_tables._patterns
            if op in ("re_match", "glob")]
    check(len(rows) > 0, "the library registered no regex rows")
    lib_pats = [MatchTables.glob_regex(p) if op == "glob" else p
                for op, p in rows]
    check_k3("library rows x corpus", lib_pats, vocab(lib_drv.strtab))

    # the hard set: every edge length, P*V not a multiple of the block
    hard = hard_vocab(7, 1001)
    check((len(HARD_PATTERNS) * len(hard)) % 256 != 0, "hard set aligned")
    check_k3("hard set", HARD_PATTERNS, hard)
    for k in EDGE_LENGTHS:
        one = [("ab" * 64)[:k], "a" * k, "x" * max(k - 1, 0) + "z"[:k]]
        check_k3(f"hard set, length {k}", HARD_PATTERNS, one)


def phase_k4_synthetic(dev) -> None:
    import torch

    from gatekeeper_tpu_torch.ir import join as tjoin
    from gatekeeper_tpu_torch.ir.carry import tree_from_numpy
    from gatekeeper_tpu_torch.kernels.join_member import (
        join_member, join_member_plain)
    from tests.torch_kernel_cases import k4_synthetic

    # len(u) 4096 is a power of two: Kb == len(u), no padding
    for case in ((0, 4096, 2, 10_001, 3), (1, 3000, 2, 777, 2),
                 (2, 1, 1, 300, 1)):
        arrs = k4_synthetic(*case)
        args = tree_from_numpy(arrs, dev)
        got = join_member(*args, tjoin.KEY_PAD)
        ref = join_member_plain(*args, tjoin.KEY_PAD)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"K4 != plain on synthetic {case}")
        kb, n = arrs[0].shape[0], arrs[3].shape[0]
        log(f"[K4] synthetic len(u) {case[1]}, Kb {kb}, G {case[2]}, N {n},"
            f" H {arrs[3].shape[1]}: bit-exact ({int(ref.sum())} fire)")
        check(0 < int(ref.sum()) < n, f"K4 synthetic {case} is vacuous")


def phase_audit(dev, report: dict) -> None:
    from gatekeeper_tpu_torch.client import Backend, RegoDriver
    from gatekeeper_tpu_torch.ir import TorchDriver
    from gatekeeper_tpu_torch.kernels.clause import clause_words
    from gatekeeper_tpu_torch.kernels.pair_compact import pair_compact
    from gatekeeper_tpu_torch.kernels.regex_scan import regex_scan
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
    k3_before = regex_scan.launches
    t0 = time.perf_counter()
    res = client.audit().results()
    first = time.perf_counter() - t0
    k3 = regex_scan.launches - k3_before
    check(drv.last_audit_path == "single(cuda)",
          f"config-4 first audit took path {drv.last_audit_path}")
    k2 = clause_words.launches - before[0]
    k1 = pair_compact.launches - before[1]
    check(len(res) == CONFIG4_RESULTS,
          f"config-4 audit returned {len(res)} results, want "
          f"{CONFIG4_RESULTS}")
    # its 7 regex rows span the whole vocabulary (label values only: the
    # template reads no names), so K3 runs iff that beats the crossover
    from gatekeeper_tpu_torch.ops import regex_nfa

    evals = sum(op == "re_match" for op, _p in drv.match_tables._patterns
                ) * len(drv.strtab)
    check((k3 > 0) == (evals >= regex_nfa.DEVICE_CROSSOVER),
          f"config-4 audit: {evals} regex evaluations, DEVICE_CROSSOVER "
          f"{regex_nfa.DEVICE_CROSSOVER}, K3 launches {k3}")
    t0 = time.perf_counter()
    res2 = client.audit().results()
    steady = time.perf_counter() - t0
    check(result_key(res2) == result_key(res), "steady audit differs")
    check(drv.last_audit_path == "delta(1/1)",
          f"config-4 steady audit took path {drv.last_audit_path}")
    check(k2 > 0 and k1 > 0, f"audit launches: K2 {k2}, K1 {k1}")
    check((clause_words.launches - before[0], pair_compact.launches
           - before[1]) == (k2, k1), "the delta-served audit launched")
    counts = drv.eval_counts()
    check(counts.get(("K8sRequiredLabels", "device"), 0) == 1 and
          counts.get(("K8sRequiredLabels", "delta"), 0) == 1,
          f"requiredlabels: eval counts {counts}")
    log(f"[audit] config 4: {len(res)} results; first audit {first:.3f} s "
        f"(launches K2 {k2}, K1 {k1}, K3 {k3}; {evals} regex "
        f"evaluations), steady audit {steady:.3f} s (path "
        f"{drv.last_audit_path}, no launch)")
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


def general_client(driver):
    from gatekeeper_tpu_torch import policies
    from gatekeeper_tpu_torch.client import Backend
    from gatekeeper_tpu_torch.parallel.workload import GENERAL_CONSTRAINTS
    from gatekeeper_tpu_torch.target import K8sValidationTarget

    client = Backend(driver).new_client([K8sValidationTarget()])
    for name in policies.names():
        if name.startswith("general/"):
            client.add_template(policies.load(name))
    for c in GENERAL_CONSTRAINTS:
        client.add_constraint(library_constraint(*c))
    return client


def with_collisions(objs: list[dict]) -> list[dict]:
    """The objects plus copies, in another namespace, of the Ingress and
    the Service among the first 6 of every 50 objects:
    synth_mixed_objects' hosts and selectors are all unique, so without
    copies no join would ever fire."""
    dups = [{**o, "metadata": {**o["metadata"], "name": f"dup-{i}",
                               "namespace": "dup"}}
            for i, o in enumerate(objs)
            if o["kind"] in ("Ingress", "Service") and i % 50 < 6]
    return objs + dups


def phase_general(dev, report: dict):
    """The general library's audit at BENCH config 2's generator; returns
    the 100,000-object driver (its K4 inputs feed the last phase)."""
    from gatekeeper_tpu_torch.ir import TorchDriver
    from gatekeeper_tpu_torch.kernels.join_member import join_member
    from gatekeeper_tpu_torch.kernels.regex_scan import regex_scan
    from gatekeeper_tpu_torch.parallel.workload import synth_mixed_objects

    from gatekeeper_tpu_torch.ops import regex_nfa
    from gatekeeper_tpu_torch.ops.strtab import MatchTables

    big = None
    for n, want in GENERAL_RESULTS.items():
        t0 = time.perf_counter()
        drv = TorchDriver()
        client = general_client(drv)
        for o in synth_mixed_objects(n):
            client.add_data(o)
        ingest = time.perf_counter() - t0
        k4, k3 = join_member.launches, regex_scan.launches
        t0 = time.perf_counter()
        res = client.audit().results()
        first = time.perf_counter() - t0
        k4_first = join_member.launches - k4
        check(len(res) == want, f"general audit of {n} objects returned "
              f"{len(res)} results, want {want}")
        check(drv.last_audit_path == "single(cuda)",
              f"general first audit of {n} took {drv.last_audit_path}")
        # the regex rows were built early in the first audit, over the
        # few strings interned by then; the next full sweep extends them
        # over the rest of the vocabulary in one window
        mt = drv.match_tables
        V = len(drv.strtab)
        pend = [(r, mt._built_len[r]) for r, (op, _p)
                in enumerate(mt._patterns)
                if op in ("re_match", "glob") and mt._built_len[r] < V]
        check(len({b for _r, b in pend}) == 1,
              f"general audit of {n}: regex rows pending in "
              f"{len({b for _r, b in pend})} windows, want 1")
        built = pend[0][1]
        window = mt._window(built, V)
        pats = [MatchTables.glob_regex(p) if op == "glob" else p
                for op, p in (mt._patterns[r] for r, _b in pend)]
        evals = len(pats) * len(window)
        cross = measure_crossover(f"general {n} steady audit", pats,
                                  window, dev)
        report.setdefault("K3_crossover", {})[f"general {n}"] = cross
        k3 = regex_scan.launches
        t0 = time.perf_counter()
        res2 = client.audit().results()
        steady = time.perf_counter() - t0
        check(result_key(res2) == result_key(res),
              f"steady general audit of {n} differs")
        # the 5 review-pure kinds are delta-served, the 2 joins read data
        check(drv.last_audit_path == "delta(5/7)",
              f"general steady audit of {n} took {drv.last_audit_path}")
        check(regex_scan.launches == k3, "the steady audit extended rows")
        counts = drv.eval_counts()
        for kind in JOIN_KINDS:
            jc = drv.join_for(kind)
            check(counts.get((kind, "join"), 0) >= 2 and
                  not counts.get((kind, "interp"), 0),
                  f"{kind} at {n} objects: eval counts {counts}")
            check(bool(jc._dev_rev_cache),
                  f"{kind} at {n} objects never took K4")
        check(k4_first >= len(JOIN_KINDS),
              f"K4 launched {k4_first} times in the first audit of {n}")
        check(drv.fallback_reasons() == {}, "a general kind fell back")
        line = (f"[general] {n} objects: {len(res)} results; ingest "
                f"{ingest:.1f} s, first audit {first:.3f} s, steady audit "
                f"{steady:.3f} s ({drv.last_audit_path}); K4 {k4_first} "
                "launches in the first audit")
        rec = {"results": len(res), "first_s": first, "steady_s": steady}
        if n in GENERAL_EDIT_RESULTS:
            # a policy edit, match unchanged: the 5 compiled kinds sweep
            # again over their cached features, and the sweep extends the
            # regex rows over the strings the joins interned
            client.add_constraint(library_constraint(*GENERAL_EDIT))
            k3 = regex_scan.launches
            t0 = time.perf_counter()
            res3 = client.audit().results()
            edit = time.perf_counter() - t0
            k3_edit = regex_scan.launches - k3
            check(len(res3) == GENERAL_EDIT_RESULTS[n],
                  f"general edit round of {n} returned {len(res3)} "
                  f"results, want {GENERAL_EDIT_RESULTS[n]}")
            check(drv.last_audit_path == "single(cuda)",
                  f"general edit round of {n} took {drv.last_audit_path}")
            check((k3_edit > 0) == (evals >= regex_nfa.DEVICE_CROSSOVER),
                  f"general edit round of {n}: {evals} regex evaluations, "
                  f"DEVICE_CROSSOVER {regex_nfa.DEVICE_CROSSOVER}, K3 "
                  f"launches {k3_edit}")
            line += (f"; edit round {edit:.3f} s, {len(res3)} results, K3 "
                     f"{k3_edit} launches ({len(pats)} regex rows x "
                     f"{len(window)} new strings; vocab {V})")
            rec.update(edit_s=edit, edit_results=len(res3))
        log(line)
        report[f"general_{n}"] = rec
        big = (drv, client, pats, window)
    return big


def phase_general_subset(dev) -> None:
    """The 2,000-object general subset (plus colliding copies) against
    the interpreter, with MIN_DEVICE_REVIEWS forced to 1 so that every
    join evaluation goes through K4. Run after the main path's launch
    counts are read: its launches come from the forced threshold."""
    from gatekeeper_tpu_torch.client import RegoDriver
    from gatekeeper_tpu_torch.ir import TorchDriver
    from gatekeeper_tpu_torch.ir import join as tjoin
    from gatekeeper_tpu_torch.kernels.join_member import join_member
    from gatekeeper_tpu_torch.parallel.workload import synth_mixed_objects

    saved = tjoin.JoinCompiled.MIN_DEVICE_REVIEWS
    tjoin.JoinCompiled.MIN_DEVICE_REVIEWS = 1
    try:
        objs = with_collisions(synth_mixed_objects(SUBSET))
        keys = []
        for driver in (TorchDriver(), RegoDriver()):
            client = general_client(driver)
            for o in objs:
                client.add_data(o)
            k4 = join_member.launches
            keys.append(result_key(client.audit().results()))
            if isinstance(driver, TorchDriver):
                check(join_member.launches - k4 >= len(JOIN_KINDS),
                      "the subset's joins did not take K4")
    finally:
        tjoin.JoinCompiled.MIN_DEVICE_REVIEWS = saved
    got, want = keys
    # the device driver orders results by kind (as the JAX package's
    # TpuDriver does), the interpreter by object: equal per constraint
    names = sorted({k[1] for k in want})
    check(sorted(got) == sorted(want) and all(
        [k for k in got if k[1] == c] == [k for k in want if k[1] == c]
        for c in names), f"{len(objs)}-object general audit differs from "
        "the interpreter")
    joined = sum(1 for k in got if k[1].startswith("unique-"))
    check(joined > 0, "the subset's joins never fired")
    log(f"[general] {len(objs)}-object subset: {len(got)} results "
        f"({joined} from the joins) equal the interpreter's per "
        "constraint (msg, constraint, resource, action, order)")


def phase_k3_path(dev, report: dict, pats, window) -> None:
    """K3 against its plain version, and its time, at the shape the main
    path launched it: the general 100,000-object steady audit's window."""
    import torch

    from gatekeeper_tpu_torch.kernels.regex_scan import (
        regex_scan, regex_scan_plain)
    from gatekeeper_tpu_torch.ops import regex_nfa

    dfas = [regex_nfa.try_compile_device(p) for p in pats]
    args = k3_args(dfas, regex_nfa.scan_prep(window)[0], dev)
    got = regex_scan(*args)
    ref = regex_scan_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), "K3 != plain at the main path's shape")
    kms = cuda_ms(lambda: regex_scan(*args))
    pms = cuda_ms(lambda: regex_scan_plain(*args), reps=3, warmup=1)
    nbytes, ops = k3_work(args)
    bms, by = bound_ms(nbytes, ops)
    log(f"[K3] main-path shape [{len(pats)} x {len(window)}], L "
        f"{args[4].shape[1]}, S_max {args[0].shape[1]}: bit-exact "
        f"({int(ref.sum())} matches); kernel {kms:.4f} ms, plain "
        f"{pms:.4f} ms, bound {bms:.6f} ms ({by}: {nbytes:.0f} B, "
        f"{ops:.0f} ops)")
    report["K3"] = {"max_abs_err": 0, "ms": kms, "plain_ms": pms,
                    "bound_ms": bms, "bound_by": by, "library_ms": None}


def phase_k4_shapes(dev, report: dict, big) -> None:
    """K3 and K4 at the 100,000-object audit's own inputs, and the host
    probe against K4 over growing candidate lists."""
    import torch

    from gatekeeper_tpu_torch.ir import join as tjoin
    from gatekeeper_tpu_torch.kernels.join_member import (
        join_member, join_member_plain)

    drv, _client, pats, window = big
    phase_k3_path(dev, report, pats, window)
    inv = drv._inventory_tree(TARGET)
    reviews = drv._inventory_reviews(TARGET)
    rev_cache = drv._join_frz[1]
    frz = [rev_cache[id(r)][1] for r in reviews if id(r) in rev_cache]
    times = {}
    for kind in JOIN_KINDS:
        jc = drv.join_for(kind)
        args = jc._dev_inv_cache[0][2] + jc._dev_rev_cache[0][2]
        u_p, cnt_p, sik_p, karr, iks = args
        got = join_member(*args, tjoin.KEY_PAD)
        ref = join_member_plain(*args, tjoin.KEY_PAD)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"K4 != plain on {kind}'s audit")
        kms = cuda_ms(lambda: join_member(*args, tjoin.KEY_PAD))
        pms = cuda_ms(lambda: join_member_plain(*args, tjoin.KEY_PAD))
        lms = cuda_ms(lambda: torch.searchsorted(u_p, karr))
        N, H = karr.shape
        kb, G = u_p.shape[0], sik_p.shape[0]
        real = int((karr != tjoin.KEY_PAD).sum())
        nbytes, ops = k4_work(args, tjoin.KEY_PAD)
        bms, by = bound_ms(nbytes, ops)
        log(f"[K4] {kind} at 100,000 objects: N {N}, H {H}, Kb {kb}, G {G},"
            f" {real} real keys, {int(ref.sum())} fire: bit-exact; kernel "
            f"{kms:.4f} ms, plain {pms:.4f} ms, torch.searchsorted (search "
            f"only) {lms:.4f} ms, bound {bms:.6f} ms ({by}: {nbytes:.0f} B,"
            f" {ops:.0f} ops)")
        times[kind] = {"max_abs_err": 0, "ms": kms, "plain_ms": pms,
                       "bound_ms": bms, "bound_by": by, "library_ms": lms}
        # MIN_DEVICE_REVIEWS' break-even: the same fires() call, review
        # keys cached, through the host dict probe and through K4
        key_cache = drv._join_frz[2][kind]
        for n in JOIN_N:
            sub = frz[:n]
            row = {}
            for label, floor in (("host", 1 << 30), ("K4", 1)):
                jc.MIN_DEVICE_REVIEWS = floor
                jc.fires(sub, inv, drv._data_gen, key_cache=key_cache)
                reps = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    jc.fires(sub, inv, drv._data_gen, key_cache=key_cache)
                    reps.append(time.perf_counter() - t0)
                row[label] = sorted(reps)[1]
            del jc.MIN_DEVICE_REVIEWS  # back to the class's 2048
            log(f"[K4] {kind} fires() over {len(sub)} candidates: host "
                f"probe {row['host'] * 1e3:.3f} ms, K4 path "
                f"{row['K4'] * 1e3:.3f} ms")
            report.setdefault("K4_break_even", {}).setdefault(
                kind, {})[len(sub)] = row
    # the line's K4 entry: the ingress kind (both are the same shape)
    report["K4"] = times[JOIN_KINDS[0]]


def psp_client(driver, pods):
    from gatekeeper_tpu_torch import policies
    from gatekeeper_tpu_torch.client import Backend
    from gatekeeper_tpu_torch.parallel.workload import PSP_CONSTRAINTS
    from gatekeeper_tpu_torch.target import K8sValidationTarget

    client = Backend(driver).new_client([K8sValidationTarget()])
    for name in policies.names():
        if name.startswith("pod-security-policy/"):
            client.add_template(policies.load(name))
    for c in PSP_CONSTRAINTS:
        client.add_constraint(library_constraint(*c))
    for o in pods:
        client.add_data(o)
    return client


def check_resident(drv, dev) -> int:
    """Every device-resident feature leaf equals a fresh upload of its
    host array, byte for byte. Returns the number of leaves."""
    import torch

    from gatekeeper_tpu_torch.ir.carry import to_tensor

    n = 0
    for kind, fc in drv._feat_cache.items():
        for arrs in fc["__meta__"]["feats"].values():
            for a in arrs.values():
                ent = drv._dev_cache.get(id(a))
                check(ent is not None and ent[0]() is a,
                      f"{kind}: a feature leaf is not resident")
                fresh = to_tensor(a, dev)
                check(torch.equal(ent[1].view(torch.uint8),
                                  fresh.view(torch.uint8)),
                      f"{kind}: a resident leaf differs from its host array")
                n += 1
    return n


def dirty_kinds(drv) -> int:
    """Kinds whose candidates hold a row the journal dirtied since their
    features were cached (each takes one K5 launch when patched)."""
    import numpy as np

    out = 0
    for fc in drv._feat_cache.values():
        meta = fc["__meta__"]
        notes = drv._notes_between(meta["rev"], drv._data_rev) or []
        dirty = [n[3] for n in notes if n[2] == TARGET]
        out += bool(np.isin(dirty, meta["cand"]).any())
    return out


def phase_churn(dev, report: dict):
    """BENCH config 6 on the main path; returns its driver (phase 13
    times K5 at its shapes) and, per kind, the inputs of its K2 launches
    in the first audit with the seconds its first launch took (Triton's
    compile included), recorded through a wrapper on the clause_words
    that TorchDriver's templates call."""
    import random

    from gatekeeper_tpu_torch.ir import TorchDriver, evaltorch
    from gatekeeper_tpu_torch.ir import driver as tdriver
    from gatekeeper_tpu_torch.kernels.rows_update import rows_update
    from gatekeeper_tpu_torch.parallel.workload import (
        CHURN_STEPS, churn_step, synth_pods_psp)

    t0 = time.perf_counter()
    drv = TorchDriver()
    pods = synth_pods_psp(CONFIG6_PODS)
    client = psp_client(drv, pods)
    log(f"[churn] config 6 ingest ({CONFIG6_PODS} pods, 16 templates): "
        f"{time.perf_counter() - t0:.1f} s")
    rng = random.Random(6)
    count = CONFIG6_PODS // 100
    # extract_batch counted by wrapping the module function
    extracts = [0]
    orig = tdriver.extract_batch

    def counting(*a, **k):
        extracts[0] += 1
        return orig(*a, **k)

    tdriver.extract_batch = counting
    k2_seen: dict = {}
    k2_orig = evaltorch.clause_words
    k2_recording = k2_recorder(k2_orig, k2_seen)
    rec: dict = {"pods": CONFIG6_PODS, "churn": count}
    e1 = None
    try:
        for step, round_, edit in CHURN_STEPS:
            churn_step(client, drv, pods, rng, count, round_, edit)
            want_k5 = dirty_kinds(drv) if step in ("E1", "E2") else 0
            extracts[0] = 0
            k5 = rows_update.launches
            if step == "first":
                evaltorch.clause_words = k2_recording
            t0 = time.perf_counter()
            try:
                res = client.audit().results()
            finally:
                evaltorch.clause_words = k2_orig
            el = time.perf_counter() - t0
            path = drv.last_audit_path
            k5 = rows_update.launches - k5
            want = (CONFIG6_EDIT_RESULTS if step == "E1" else len(e1)
                    if step == "re-encode" else CONFIG6_RESULTS)
            check(len(res) == want, f"config 6 {step}: {len(res)} results,"
                  f" want {want}")
            full = step in ("first", "E1", "re-encode", "E2")
            check(path == ("single(cuda)" if full else "delta(16/16)"),
                  f"config 6 {step}: path {path}")
            check(k5 == want_k5, f"config 6 {step}: K5 launched {k5} times,"
                  f" want {want_k5}")
            if step in ("first", "re-encode"):
                check(extracts[0] == 16, f"config 6 {step}: "
                      f"{extracts[0]} extractions, want 16")
            else:
                check(extracts[0] == 0, f"config 6 {step}: extract_batch "
                      f"ran {extracts[0]} times")
            extra = ""
            if step in ("E1", "E2"):
                check(want_k5 == 16, f"config 6 {step}: {want_k5} kinds "
                      "hold a dirty row, want 16")
                extra = (f"; K5 {k5} launches, {check_resident(drv, dev)} "
                         "resident leaves equal fresh uploads")
            if step == "E1":
                e1 = result_key(res)
            if step == "re-encode":
                check(result_key(res) == e1, "the full re-encode differs "
                      "from E1")
            log(f"[churn] {step}: {len(res)} results, {el:.3f} s, path "
                f"{path}{extra}")
            rec[step] = {"results": len(res), "s": el}
    finally:
        tdriver.extract_batch = orig
    rec["incremental_s"] = min(rec[f"churn {k}"]["s"] for k in (2, 3, 4))
    report["config6"] = rec
    return drv, recorded_k2(drv, k2_seen)


def k2_recorder(orig, seen: dict):
    """A stand-in for the clause_words that TorchDriver's templates call
    (evaltorch.clause_words): it calls `orig` and records in `seen`, per
    kernel cache and feature shapes, the first call's plans, inputs and
    seconds (generation and Triton's compile included)."""

    def recording(plans, feats, params, table, derived, chunk=8192,
                  cache=None):
        key = (id(cache), tuple(tuple(a.shape) for arrs in feats.values()
                                for a in arrs.values()))
        fresh = key not in seen
        t0 = time.perf_counter()
        out = orig(plans, feats, params, table, derived, chunk=chunk,
                   cache=cache)
        if fresh:
            seen[key] = (plans, (feats, params, table, derived),
                         time.perf_counter() - t0)
        return out

    return recording


def recorded_k2(drv, seen: dict) -> list:
    """k2_recorder's records as (kind, plans, inputs, first-call s),
    sorted by kind."""
    names = {id(drv.compiled_for(k)._kernels): k
             for k in drv.compiled_kinds()}
    return sorted(((names[key[0]],) + val for key, val in seen.items()),
                  key=lambda t: t[0])


def phase_k2_config6(dev, report: dict, k2_inputs) -> None:
    """K2 against its plain version, and its time, for each of config 6's
    16 kinds at the inputs of its first-audit launch (the slab of 32,768
    rows); the first launches' seconds were taken on the main path."""
    check(len({k for k, *_r in k2_inputs}) == 16,
          f"config 6 recorded K2 inputs for {len(k2_inputs)} shapes")
    times = {}
    for kind, plans, ins, first in k2_inputs:
        rec = time_k2(f"config 6 {kind}", plans, ins, first)
        times[kind] = {"ms": rec["ms"], "first_s": first}
    total = sum(t["first_s"] for t in times.values())
    ms_total = sum(t["ms"] for t in times.values())
    log(f"[K2] config 6: {len(times)} kinds, kernels {ms_total:.4f} ms in "
        f"all, first launches {total:.2f} s in all")
    report["K2_config6"] = {"first_s_total": total, "ms_total": ms_total,
                            "kinds": times}


def config6_k2_inputs() -> list:
    """Each config-6 kind's K2 inputs in its first audit of
    synth_pods_psp(50,000), with its first launch's seconds, recorded
    through TorchDriver as phase_churn records them."""
    from gatekeeper_tpu_torch.ir import TorchDriver, evaltorch
    from gatekeeper_tpu_torch.parallel.workload import synth_pods_psp

    drv = TorchDriver()
    client = psp_client(drv, synth_pods_psp(CONFIG6_PODS))
    seen: dict = {}
    orig = evaltorch.clause_words
    evaltorch.clause_words = k2_recorder(orig, seen)
    try:
        n = len(client.audit().results())
    finally:
        evaltorch.clause_words = orig
    check(n == CONFIG6_RESULTS, f"config 6 first audit: {n} results")
    return recorded_k2(drv, seen)


# K2 tiles the --tune sweep times, (BLOCK_N, words per program,
# num_warps, narrow elements) as clause_triton.CONFIG takes them; the
# shipped one first
TUNE_CONFIGS = [(8, 2, 4, 256), (4, 8, 4, 256), (16, 1, 4, 512),
                (16, 2, 8, 256), (8, 1, 4, 256), (16, 2, 4, 2048),
                (8, 4, 4, 256), (16, 1, 8, 4096)]


def kernels_only(dev, tune: bool, tag: str) -> None:
    """K2 and K1 alone, for comparing two checkouts (--root) or K2's tiles
    (--tune) on one card: K2 at the flagship slab, the 21 corpus templates
    and config 6's 16 kinds at their first-audit shapes, each against its
    plain version; K1 on the flagship slab's words. Uses only entry points
    that every slice of the port has. Prints one JSON line per kernel and
    one summary line per run (per tile with --tune)."""
    from gatekeeper_tpu_torch.kernels import clause_triton
    from gatekeeper_tpu_torch.kernels.clause import clause_words

    t0 = time.perf_counter()
    _drv, plans, feats, params, table, derived = flagship_inputs(dev)
    flag = (plans, (slab_of(feats), params, table, derived))
    del feats
    entries = [("flagship", *flag, None)]
    _cdrv, corp = corpus_k2_inputs()
    entries += [(f"corpus:{k}", p, ins, None) for k, p, ins in corp]
    entries += [(f"config6:{k}", p, ins, first) for k, p, ins, first
                in config6_k2_inputs()]
    setup_s = time.perf_counter() - t0

    def summary(recs) -> dict:
        by: dict = {}
        for r in recs:
            by.setdefault(r["name"].split(":")[0], []).append(r)
        return {"root": tag, "setup_s": setup_s,
                "k2_flagship_ms": by["flagship"][0]["ms"],
                **{f"k2_{g}_ms_sum": sum(r["ms"] for r in v)
                   for g, v in by.items() if g != "flagship"},
                **{f"k2_{g}_first_s_sum": sum(r["first_s"] for r in v)
                   for g, v in by.items()},
                "all_exact": all(r["exact"] for r in recs),
                "max_regs": max((r["n_regs"] or 0) for r in recs),
                "spills": sum((r["n_spills"] or 0) for r in recs)}

    if not tune:
        recs = [time_k2(*e) for e in entries]
        for r in recs:
            print(json.dumps(dict(r, kernel="K2", root=tag)))
        words = clause_words(flag[0], *flag[1], cache={})
        k1 = time_k1_slab(words.contiguous(), CONFIG4[1])
        print(json.dumps(dict(k1, kernel="K1", root=tag)))
        print(json.dumps(dict(summary(recs), k1_ms=k1["ms"],
                              k1_kernels_per_call=k1["kernels_per_call"])))
        return
    # every tile compiles anew: each first launch is timed here
    for cfg in TUNE_CONFIGS:
        clause_triton.CONFIG = cfg
        recs = [time_k2(name, p, ins, strict=False)
                for name, p, ins, _f in entries]
        for r in recs:
            print(json.dumps(dict(r, kernel="K2", root=tag, tile=cfg)))
        print(json.dumps(dict(summary(recs), tile=cfg)))


def phase_churn_subset(dev) -> None:
    """Config 6's rounds over a 2,000-pod subset through a second
    TorchDriver and through RegoDriver: equal in every round."""
    import copy
    import random

    from gatekeeper_tpu_torch.client import RegoDriver
    from gatekeeper_tpu_torch.ir import TorchDriver
    from gatekeeper_tpu_torch.parallel.workload import (
        CHURN_STEPS, churn_step, synth_pods_psp)

    pods = synth_pods_psp(CHURN_SUBSET)
    sides = []
    for driver in (TorchDriver(), RegoDriver()):
        client = psp_client(driver, copy.deepcopy(pods))
        sides.append((driver, client, random.Random(6)))
    for step, round_, edit in CHURN_STEPS:
        keys = []
        for driver, client, rng in sides:
            churn_step(client, driver, pods, rng, CHURN_SUBSET // 100,
                       round_, edit)
            keys.append(result_key(client.audit().results()))
        got, want = keys
        # the device driver orders results by kind, the interpreter by
        # object: equal per constraint
        check(sorted(got) == sorted(want) and all(
            [k for k in got if k[1] == c] == [k for k in want if k[1] == c]
            for c in {k[1] for k in want}),
            f"{CHURN_SUBSET}-pod churn subset, {step}: differs from the "
            "interpreter")
        log(f"[churn subset] {step}: {len(got)} results equal the "
            f"interpreter's per constraint (path "
            f"{sides[0][0].last_audit_path})")


def phase_k5_path(dev, report: dict, drv) -> None:
    """K5 against its plain version at config 6's shapes: 500 rows into
    every feature leaf of the kind with the widest rows, n_pad its
    bucket; its time, index_copy_'s, and the whole patch path (stage,
    copy, K5) against a full re-upload of the kind's leaves."""
    import numpy as np
    import torch

    from gatekeeper_tpu_torch.ir.carry import to_tensor
    from gatekeeper_tpu_torch.kernels.rows_update import (
        launch, rows_update, rows_update_plain, stage)

    def leaves(kind):
        feats = drv._feat_cache[kind]["__meta__"]["feats"]
        return [a for arrs in feats.values() for a in arrs.values()]

    kind = max(drv._feat_cache, key=lambda k: sum(
        a.nbytes // a.shape[0] for a in leaves(k)))
    host = leaves(kind)
    n = len(drv._feat_cache[kind]["__meta__"]["cand"])
    m = CONFIG6_PODS // 100
    rng = np.random.default_rng(6)
    pos = np.sort(rng.choice(n, m, replace=False)).astype(np.int32)
    # rows taken from other pods, so that the patch changes the leaves
    rows = [a[rng.choice(n, m, replace=False)] for a in host]
    rows = [r.view(np.int32) if r.dtype == np.uint32 else r for r in rows]
    resident = [drv._dev_cache[id(a)][1] for a in host]
    got = [t.clone() for t in resident]
    ref = [t.clone() for t in resident]
    rows_update(got, pos, rows)
    pos_d = torch.from_numpy(pos).to(dev)
    rows_d = [to_tensor(r, dev).view(t.dtype) for r, t in zip(rows, ref)]
    rows_update_plain(ref, pos_d, rows_d)
    torch.cuda.synchronize()
    err = max(int((g.view(torch.uint8).int() - r.view(torch.uint8).int())
                  .abs().max()) for g, r in zip(got, ref))
    check(err == 0, f"K5 != plain at config 6's shapes ({kind})")
    check(any(not torch.equal(g.view(torch.uint8), t.view(torch.uint8))
              for g, t in zip(got, resident)), "K5's patch changed nothing")
    args = stage(got, pos, rows)
    kms = cuda_ms(lambda: launch(*args))
    pms = cuda_ms(lambda: rows_update_plain(ref, pos_d, rows_d))
    idx = pos_d.long()
    lms = cuda_ms(lambda: [d.index_copy_(0, idx, r)
                           for d, r in zip(ref, rows_d)])
    row_bytes = sum(r.nbytes for r in rows)
    nbytes = 2 * row_bytes + 4 * m
    bms, by = bound_ms(nbytes, 0)

    def host_ms(fn) -> float:
        reps = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            reps.append(time.perf_counter() - t0)
        return sorted(reps)[2] * 1e3

    patch_ms = host_ms(lambda: rows_update(got, pos, rows))
    full_ms = host_ms(lambda: [to_tensor(a, dev) for a in host])
    full_bytes = sum(a.nbytes for a in host)
    log(f"[K5] config 6 shape: {kind}, {len(host)} leaves, n_pad "
        f"{host[0].shape[0]}, m {m}, {row_bytes} row bytes: bit-exact; "
        f"kernel {kms:.4f} ms, plain {pms:.4f} ms, index_copy_ {lms:.4f} "
        f"ms, bound {bms:.6f} ms ({by}: {nbytes} B); patch path (stage, "
        f"copy, K5; host clock, median of 5) {patch_ms:.3f} ms vs full "
        f"re-upload of {full_bytes} B {full_ms:.3f} ms")
    report["K5"] = {"max_abs_err": err, "ms": kms, "plain_ms": pms,
                    "bound_ms": bms, "bound_by": by, "library_ms": lms}
    report["K5_path"] = {"kind": kind, "leaves": len(host), "m": m,
                         "n_pad": int(host[0].shape[0]),
                         "patch_path_ms": patch_ms,
                         "full_reupload_ms": full_ms,
                         "full_reupload_bytes": full_bytes}


def phase_batches(dev, report: dict) -> None:
    from batch_profile import GcClock
    from gatekeeper_tpu_torch.client import RegoDriver
    from gatekeeper_tpu_torch.ir import TorchDriver
    from gatekeeper_tpu_torch.kernels.clause import clause_words
    from gatekeeper_tpu_torch.kernels.pair_compact import pair_compact

    drv = TorchDriver()
    client = library_client(drv, compiled_only=False)
    oracle = library_client(RegoDriver(), compiled_only=False)
    # the corpus as inventory, so the join kinds have objects to join
    for o in corpus(2000):
        client.add_data(o)
        oracle.add_data(o)
    gc_clock = GcClock()
    for n, branch in BATCHES:
        objs = corpus(n)
        before = clause_words.launches, pair_compact.launches
        # one batch each, to keep the whole script inside its time limit
        gc_clock.read()
        t0 = time.perf_counter()
        got = client.review_batch(objs)
        first = time.perf_counter() - t0
        gc_s = gc_clock.read()["gc_s"]
        want = oracle.review_batch(objs)
        gk = [result_key(r.results()) for r in got]
        check(gk == [result_key(r.results()) for r in want],
              f"review batch of {n} differs from the interpreter")
        k2 = clause_words.launches - before[0]
        k1 = pair_compact.launches - before[1]
        check(k2 > 0, f"batch of {n}: K2 never launched")
        if branch == "sparse":
            check(k1 > 0, f"batch of {n}: K1 never launched")
        log(f"[batch] {n} manifests ({branch}): "
            f"{sum(len(k) for k in gk)} results equal the interpreter; "
            f"first {first:.3f} s ({gc_s:.3f} s of it in Python's garbage "
            f"collector); launches K2 {k2}, K1 {k1}")
        report[f"batch_{n}"] = {"first_s": first, "gc_s": gc_s}
    gc_clock.stop()
    check(drv.fallback_reasons() == {}, "a compiled kind fell back")
    check(len(drv.compiled_kinds()) == 23, "expected 23 device kinds")
    demoted = [k for k in drv._programs
               if drv._compiled.get(k, True) is None]
    check(not demoted, f"demoted kinds: {demoted}")
    counts = drv.eval_counts()
    missing = [k for k in drv.compiled_kinds()
               if counts.get((k, "interp"), 0)]
    check(not missing, f"kinds served by the interpreter: {missing}")
    check(all(counts.get((k, "join"), 0) for k in JOIN_KINDS),
          f"a join kind took no join evaluation: {counts}")


def main() -> int:
    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--kernels", action="store_true",
                    help="K2 and K1 alone (see kernels_only)")
    ap.add_argument("--tune", action="store_true",
                    help="with --kernels: time every tile of TUNE_CONFIGS")
    ap.add_argument("--root", default=ROOT,
                    help="with --kernels: the checkout whose package is "
                    "imported (default: this script's own)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    if root != ROOT and not args.kernels:
        ap.error("--root is for --kernels runs")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    try:
        import gatekeeper_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    if args.kernels:
        # a Triton cache of this run's own, so that every first launch
        # compiles; removed at exit
        build = os.path.join(root, "gatekeeper_tpu_torch", "_build")
        os.makedirs(build, exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="triton-", dir=build) as tc:
            os.environ["TRITON_CACHE_DIR"] = tc
            try:
                kernels_only(torch.device("cuda"), args.tune,
                             os.path.relpath(root, ROOT))
            except Fail as e:
                print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
                return 1
        return 0
    from gatekeeper_tpu_torch.kernels.clause import clause_words
    from gatekeeper_tpu_torch.kernels.join_member import join_member
    from gatekeeper_tpu_torch.kernels.pair_compact import pair_compact
    from gatekeeper_tpu_torch.kernels.regex_scan import regex_scan
    from gatekeeper_tpu_torch.kernels.rows_update import rows_update

    wrappers = {"K1": pair_compact, "K2": clause_words, "K3": regex_scan,
                "K4": join_member, "K5": rows_update}
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
    # every phase runs on torch.device("cuda"), the current card: one
    dev = torch.device("cuda")
    cards_used = 1
    report: dict = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[{name}] phase {time.perf_counter() - t0:.1f} s")
        return out

    try:
        phase("build", phase_build, report)
        phase("K1", phase_k1, dev)
        flag_drv, lib_drv = phase("K2", phase_k2, dev, report)
        phase("K3", phase_k3, dev, report, flag_drv, lib_drv)
        del flag_drv, lib_drv
        phase("K4", phase_k4_synthetic, dev)
        # the main path: counts from 0, driven, read just after
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        phase("audit", phase_audit, dev, report)
        big = phase("general", phase_general, dev, report)
        churn_drv, c6_k2 = phase("churn", phase_churn, dev, report)
        phase("batch", phase_batches, dev, report)
        launches = {k: w.launches for k, w in wrappers.items()}
        log(f"[main] audits + batches {time.perf_counter() - t0:.1f} s; "
            f"launches {launches}")
        check(all(v > 0 for v in launches.values()),
              f"a kernel of the main path never launched: {launches}")
        phase("general subset", phase_general_subset, dev)
        phase("path shapes", phase_k4_shapes, dev, report, big)
        del big
        phase("churn subset", phase_churn_subset, dev)
        phase("K5 path shape", phase_k5_path, dev, report, churn_drv)
        phase("K2 config-6 shapes", phase_k2_config6, dev, report, c6_k2)
        del c6_k2
    except Fail as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    sources = {
        "K1": ("K1 pair_compact", "cuda",
               "gatekeeper_tpu_torch/csrc/pair_compact.cu",
               "gatekeeper_tpu/ir/evaljax.py:667"),
        "K2": ("K2 clause_words", "triton",
               "gatekeeper_tpu_torch/kernels/clause_triton.py",
               "gatekeeper_tpu/ir/evaljax.py:905"),
        "K3": ("K3 regex_scan", "cuda",
               "gatekeeper_tpu_torch/csrc/regex_scan.cu",
               "gatekeeper_tpu/ops/regex_nfa.py:447"),
        "K4": ("K4 join_member", "cuda",
               "gatekeeper_tpu_torch/csrc/join_member.cu",
               "gatekeeper_tpu/ir/join.py:1002"),
        "K5": ("K5 rows_update", "cuda",
               "gatekeeper_tpu_torch/csrc/rows_update.cu",
               "gatekeeper_tpu/ir/driver.py:2623"),
    }
    kernels = [dict(name=name, route=route, source=src, replaces=where,
                    launches=launches[k], **report[k])
               for k, (name, route, src, where) in sources.items()]
    k2_c6 = {k: v for k, v in report["K2_config6"].items() if k != "kinds"}
    log(f"[done] {time.perf_counter() - t_all:.1f} s; audit "
        f"{json.dumps(report['audit'])}; config 6 "
        f"{json.dumps(report['config6'])}; K2 config 6 "
        f"{json.dumps(k2_c6)}; K2 flagship "
        f"{json.dumps(report['K2_flagship'])}; K5 path "
        f"{json.dumps(report['K5_path'])}; K3 crossover "
        f"{json.dumps(report['K3_crossover'])}; K4 break-even "
        f"{json.dumps(report['K4_break_even'])}")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": cards_used}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
