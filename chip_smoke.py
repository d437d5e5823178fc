#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gatekeeper_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card: nvidia-smi's name and power limit, torch's device name;
  2. the build: K1 (csrc/pair_compact.cu), K3 (csrc/regex_scan.cu), K4
     (csrc/join_member.cu), K5 (csrc/rows_update.cu) and K6
     (csrc/shard_counts.cu), one nvcc each, started together, with their
     ptxas summaries, and Triton for K2;
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
     vocabulary, a hard set (classes, alternation, anchors, .*, +/?;
     string lengths 0..128), and patterns too large to share one block's
     shared memory (groups split by size, one read from global memory);
     the host re.search rate, the cost of the whole device path
     (scan_prep, then scan_device) and the crossover they give;
  6. K4 against its plain version, bit-exact, on a synthetic case with
     every sentinel, G = 2, Kb == len(u) and N not a multiple of 256;
  7. the main path, config-4 audit: Client + TorchDriver() must return
     exactly 81,346 results (first audit on the card, steady audit served
     by the delta cache), its 7 regex rows through K3 exactly when they
     reach DEVICE_CROSSOVER, and a 2,000-object subset must equal the
     interpreter (RegoDriver); phases 7, 8 and 8b print the kinds the
     cost model (_use_device_for_batch) kept on the host and its EMAs,
     and phases 7 and 8b their first audit split by phase
     (profiling.timers(): encode, device_sweep, materialize,
     interp_eval, delta_serve, compile) against its wall clock;
  8. the main path, general-library audit: the 7 general templates over
     synth_mixed_objects must return 332 results at 10,000 objects and
     1,335 at 40,000 (the JAX package's counts), the join kinds through
     K4 and never the interpreter, the steady audit delta-served for the
     5 review-pure kinds; at 40,000 a policy edit (GENERAL_EDIT) must
     return the JAX package's count, its full sweep extending the regex
     rows over the join-interned strings through K3 exactly when they
     reach DEVICE_CROSSOVER and their kinds take the device (the
     crossover is measured at that window first);
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
     and 8,192 (sparse branch, K1), each once as the cost model decides
     (per kind the path taken, then the EMAs) and once with the device
     pinned (_dev_batch_lat_s = 1e-4), must equal the interpreter per
     review; pinned, every compiled kind takes the device, none demoted;
  9b. the main path, admission webhook: the port's WebhookServer
     (ValidationHandler, the default MicroBatcher, no decision cache)
     on phase 9's driver, over loopback HTTP; phase 9's 512 dense
     manifests as admission.k8s.io/v1 CREATE AdmissionReviews (unique
     uids), sent by 32 keep-alive clients in a child process of this
     script (--loadgen), to /v1/admit?timeout=30s, in three passes: as
     the cost model decides, then pinned to the card (every batch
     dispatches, whatever its size) cold, with async warm on (a cold
     shape serves from the host while K2 compiles off the request path;
     after it, batches of 1, 3 and 16 manifests warm each row-count
     class K2 specializes on), and warm, with async warm off again. Every response must equal,
     byte for byte, the verdict (verdict_response) of phase 9's
     interpreter results; the webhook's per-review isolation must not
     fire; pinned, K2 launches on the serving threads (the warm
     thread's launches are counted apart), so cold, batches at shapes
     already warm reach the card; warm, no compiled kind is served by
     the interpreter. Per pass: p50,
     p99 and max latency, requests/s, batch sizes, kernel compiles and
     kinds per path; duty_cycle() after the warm pass; templates_debug()
     (21 kinds on K2 programs, 2 joins). Then the what-if preview
     (PreviewEngine) of a requiredlabels candidate (path device) and a
     uniqueingresshost candidate (path join) over phase 8's 10,000
     objects: the violations the preview itself counted equal the
     interpreter's;
  9c. the main path, the reconcile controllers (control/controllers.py):
     phase 9's 23 templates, their constraints and a Config syncing the
     2,000-object corpus written to a FakeKube and reconciled by a
     ControllerManager (over a GuardedKube, as the JAX package's Runtime
     wires it) onto a fresh driver; the 512 dense manifests as the cost
     model decides and pinned must equal phase 9's interpreter pairs,
     pinned with K2 on the serving thread and never on a controller's
     worker thread; after a constraint's parameters change and a
     template is deleted through the kube, the pinned batch, run inside
     profiling.device_trace, must equal a RegoDriver client under its
     own ControllerManager, with equal template and constraint statuses
     that reach a fixpoint, and the trace must name clause_kernel (its
     top device operations printed); `python -m
     gatekeeper_tpu_torch.policies.demo` runs beside it as a child on
     the card and must print ALLOWED and DENIED;
  9d. the main path, the audit manager (control/audit.py): (a) on phase
     9c's two planes (the card's and the interpreter's, 22 templates
     after the delete, the corpus synced), an AuditManager sweep in the
     default mode (discovery: every auditable kind listed, then
     review_batch) and one from the cache (client.audit(), the
     violations cap armed): per constraint the card plane's results
     equal the interpreter plane's, the statuses the two wrote are
     equal (totalViolations and at most 20 entries each), and K2
     launches; (b), in the lifecycle child after phase 16 (its launch
     counts taken there and added to phase 9d's), BENCH config 11's
     streaming audit at config 6's 50,000 pods on a FakeKube (an
     incremental manager, a 25 ms stream window): the first sweep gives
     58,902 results and statuses summing to 58,902 (K1 and K2 launch;
     its trace phases printed), the second is delta-served and writes
     no status; the stream loop serves 40 rounds of 12 pod replacements
     0.15 s apart with 0 errors (detection latency p50/p99 printed); a
     full-resync sweep gives the JAX package's post-churn count, 59,136
     (tests/torch_reference_counts.py --stream 50000), K1 and K2 launch,
     its results equal the stream's last flush per constraint and it
     rewrites no status entry the stream published (the totals it
     repairs are printed: a flush misses a total that moved past the
     cap, as in the JAX package); no status writer thread enters a
     kernel lock;
 10. a 2,000-object general subset with colliding copies must equal the
     interpreter, with MIN_DEVICE_REVIEWS forced to 1 so that every join
     goes through K4 (after the main path: its launches are not counted);
 11. K3 and K4 against their plain versions at the 40,000-object
     audit's own inputs (K3: the edit round's regex window, and the same
     window against the patterns too large to share a block's shared
     memory, with re.search; K4: both join kinds), and the host dict
     probe against K4 at N = 512, 2,048, 16,667 and 40,000
     (MIN_DEVICE_REVIEWS' break-even);
 12. the churn rounds over a 2,000-pod subset through a second
     TorchDriver and through RegoDriver, equal in every round (in the
     lifecycle child, after phase 9d (b));
 13. K5 against its plain version at phase 8b's shapes (500 rows into
     every leaf of the widest kind, whose leaves must be
     K5_HOSTFS_LEAVES), its time, and the whole patch path (stage, copy,
     K5) against a full re-upload of the kind's leaves;
 14. K2 against its plain version for each of config 6's 16 kinds at the
     inputs of its first-audit launch (recorded in phase 8b), its time,
     and the first launches' seconds in all;
 15. in a child process of this script (--lifecycle, started before
     phase 7 and run beside phases 7-14; its lines are printed after
     phase 14), the compile lifecycle with async warm on (the package
     default), in a Triton cache of its own:
     (a) config 6's first audit at 25,000 pods (29,448, the JAX
     package's count) serves cold kinds from the host while K2 warms in
     the background, until the audit's cold kinds have taken the gate's
     30 s, and blocks on the warm for the rest;
     after the drain, rounds until no shape is cold (a kind that ran
     early saw a smaller vocabulary), the last with every compiled kind
     on the card, no compile on the serving thread and its latency
     sample in the EMA; (b) config 4's first audit (50 M masked pairs,
     past the 30 s host estimate) blocks on the warm and takes the card
     (81,346); (c) the 512-manifest batch, pinned to the card, serves
     cold dense shapes from the host, then (after rounds until no shape
     is cold) runs every compiled kind on K2, equal to the interpreter
     throughout; (d) eval.device injected for one review-pure kind and
     a RuntimeError from a stand-in of the K4 wrapper for one join kind
     of the general library at 10,000 objects: 332, both kinds
     quarantined (fails 1); a second audit inside the backoff (600 s,
     the longest) neither fires the fault nor calls the stand-in for
     them, and fails stay 1; the backoff is then expired and the probe
     restores both once the faults clear. No kind of phases (a)-(c) is
     quarantined. Phases 9d (b) and 12 run in the same child after phase 16.
     (a)'s driver keeps a program store (ir/aot.py) under _build/: every
     K2 variant it compiled and every sweep signature it ran;
 16. the warm boot: a child process of phase 15's (--warm-boot DIR),
     started once (a) is done and run beside (b)-(d), with an empty
     Triton cache of its own and async warm on, boots config 6 at (a)'s
     25,000 pods on (a)'s store, waits for the prewarm to adopt every
     stored sweep signature, and runs the first audit: 29,448 results,
     all 16 kinds on the card and none on the interpreter, no "fresh" or
     "cache" compile in the process ("aot" at least once per kind) and
     no compile on the serving thread; its wall clock is printed beside
     (a)'s first audit. The child's failure, a disabled store or a store
     that loads nothing fails the smoke.
 17. the process entry point (control/main.py's Runtime), in the
     lifecycle child after phase 12, as two child processes of its own
     (--entry cold DIR, then --entry warm DIR), each with an empty Triton
     cache: BENCH config 9's cluster at 25,000 pods (parallel/workload.py
     entry_cluster: 40 Namespaces, synth_pods_psp, the 16 PSP templates
     and constraints as kube objects) seeded identically in both, the
     Runtime built with the deployment's flags (ENTRY_FLAGS, a state
     dir) and the card as its default device. (a) cold: time from
     Runtime(...) to /readyz 200; after the controllers drain, a sweep
     whose statuses hold the JAX package's totalViolations per
     constraint (ENTRY_TOTALS, tests/torch_reference_counts.py --runtime
     25000); sweeps on the card once the warm drains; 64 pods as
     AdmissionReviews to /v1/admit, each body byte-equal to the
     interpreter's verdict; /metrics with the snapshot and SLO series;
     stop(), whose drain snapshot writes the vocabulary, the library,
     the inventory, the rows and the program store. (b) warm: a new
     process restores them with no fallback; time to /readyz 200, which
     holds until the audit loop's first sweep re-validates; that sweep
     is incremental with 0 dirty, lists no Pods, adopts the rows of all
     16 kinds, runs them on the card with no fresh or cache compile in
     the process ("aot" at least once a kind) and none on a serving
     thread, and writes (a)'s statuses. Both boots' time to ready and
     first sweep are printed side by side. No kind may be quarantined.
 18. the multi-process plane and the policy service, in a child process
     of its own (--plane, started before phase 7 beside the lifecycle
     child; its lines are printed after phase 17's): (a) BENCH config 13
     (parallel/workload.py c13_objects: 200,000 pods, 2,000 Namespaces,
     200 Ingresses; requiredlabels and the ingress join) on a leader
     client, swept by an AuditShardSupervisor's two
     `gatekeeper_tpu_torch.control.engine --serve auditslice` children
     on the card (K2 compiled inline) and composed by a
     ShardedAuditPlane: the first round, a full round after a slice
     resync, two rounds of config13's routed churn and a round after
     shard 1 is SIGKILLed (respawned and resynced) must each give the
     JAX package's 200 and 0 per constraint
     (tests/torch_reference_counts.py --sharded 200000); each child
     must hold the card open (/dev/nvidia<N>) while it sweeps, and the
     duty cycle the supervisor relays from each must read above 0
     after the warm round; (b) a Runtime with --operation webhook,
     --admission-workers 2 and --admission-engines 2 (engine 1 a child
     on the same card), phase 9's library and corpus added through its
     client and replicated to the child: phase 9b's 512 manifests from
     phase 9b's load generator through the frontends, engine 1
     SIGKILLed mid-burst, every response answered and byte-equal to the
     interpreter's verdict, requests relayed from both engines, the
     victim respawned and resynced; p50, p99 and requests/s printed
     beside phase 9b's in-process pass; (c) make_server(device="cuda")
     in the child's process and a RemoteClient: phase 8's general
     library and 10,000 objects over gRPC, audit() must give 332 and
     the 512 batch the interpreter's results, K1 and K2 launching.
 19. the offline fleet scan (control/scan.py), in the plane child after
     phase 18: BENCH config 16's JSONL export (parallel/workload.py
     c16_jsonl: synth_mixed_objects(N / 8, seed 16), each object 8 times
     in config16's shuffle; its sha256 the JAX package's) cut from
     1,000,000 manifests to SCAN_MANIFESTS, scanned against the general
     library's templates and GENERAL_CONSTRAINTS (a policy dir) with 2
     loaders, batches of 256, depth 2 and a 65,536-entry dedupe LRU, in
     five runs: (a) `main(["scan", ...])` (control/main.py, as `python
     -m gatekeeper_tpu_torch.control.main scan` runs it) in a child on
     its default device, the card, with a program store and a Triton
     cache of its own, the cost model deciding; (b) cold and (c) warm,
     two children pinned to the device on one store and one Triton cache
     (scan_run: ingest_policies, build_inproc_tier, LoaderPool,
     run_scan), async warm on: (b) must compile ("fresh") every
     compiled kind's K2 variants, serving from the host until they are
     warm, and (c) load each of those kinds from the store ("aot") and
     run it on the card, with no fresh compile and none off the warm
     threads; K2 must launch in both; (d) a BackplaneEngine
     on the card in the plane child (the general library, no inventory)
     and `scan --backplane` in a child that sees no card; (e)
     make_server on the card with the same library and `scan --grpc`
     likewise. Every run must exit 1 with no error record, give the JAX
     package's counts and record digest (SCAN_REFERENCE,
     tests/torch_reference_counts.py --scan N) and quarantine no kind;
     per run its manifests/s and seconds, the paths and the launches.
 20. the audit mesh (parallel/mesh.py, parallel/collectives.py, the mesh
     half of ir/evaltorch.py and TorchDriver), in the plane child after
     phase 19, over VIRTUAL shards of the one card (a mesh that repeats
     cuda:0; plane_mesh): (a) TorchDriver() has no mesh, nor with
     GATEKEEPER_TPU_MESH=2 on one card, nor pinned to cuda:0 with a mesh
     given; (b) config 4 (500 requiredlabels x 100,000 Namespaces)
     through TorchDriver(mesh=4 x cuda:0): bucket 131,072, one K2 + K1
     dispatch a shard of 32,768 rows, last_audit_path mesh(data=4) and
     81,346 results equal in order to a single-device driver's; (c) the
     same over 2 shards, the slab loop (8 slabs of 8,192 a shard, blocks
     reassembled row-major); (d) 500 Namespaces replaced in (c)'s and
     the single driver and re-swept: equal results, K5 once for the
     single driver and once a touched shard, every shard's resident rows
     equal to the host's; (e) make_audit_step over a 4 x 2 mesh of 8 x
     cuda:0 on build_eval_setup(100,000, 500): fires equal to the
     one-device sweep, counts equal to its column sums, each shard's
     epilogue one K6 launch (8 a call) that writes its block of fires
     and adds its counts; a second, warm call equal to the first, timed,
     with the epilogue's share of it; (f) the join membership (K4) over
     8 shards equal to one launch; (g) K6 against its plain version
     (fires and counts), exactly, at config 4's shard shape [32,768, 16]
     (c 500, all rows and the last shard's 1,696), at ragged shapes
     (r_end 0 and the rows, c not a multiple of 32, W past 32) and into
     strided destinations (row stride above c, column offsets that are
     not multiples of 16), with its time, bound, plain and library
     (unpack + sum(0)) times, and its time at (e)'s shard. The
     cross-card half of the counts' sum (torch.cuda.comm.reduce_add)
     does not run on one card.
 21. scale, in a child process of its own (--scale, started beside the
     lifecycle and plane children; plane_scale): BENCH config 10
     (bench_configs.py config10: the flagship template x 100
     synth_constraints over synth_objects(1,000,000, violate_frac=0.002),
     not cut) and BENCH config 1. (a) one device (GATEKEEPER_TPU_MESH
     off): the first audit split by phase, then a full warm sweep (the
     delta cache cleared), each 29,592 results with the JAX package's
     count per constraint and result digest (SCALE_PER_CONSTRAINT,
     SCALE_DIGEST: tests/torch_reference_counts.py --config10 1000000),
     2 slabs of 507,904 rows, K1 and K2 launched, K3 exactly when the
     regex rows reach DEVICE_CROSSOVER; the pair capacity, the
     vocabulary and its capacity, the peak device memory; (b) the same
     objects through TorchDriver(mesh=8 x cuda:0): mesh(data=8), the
     local slab loop (8 slabs of 16,384 a shard of 131,072), results equal
     in order to (a)'s, first and warm; (c) make_audit_step over the 8
     shards on build_eval_setup(1,000,000, 100) (config 10's objects):
     fires equal to the one-device sweep, K6's counts equal to its
     column sums, K6 once a shard a step, then K6 alone at the shard's
     shape timed beside its bytes bound; (d) config 1 as the cost model
     decides and pinned to the device: 1 result, equal to RegoDriver's.
The kernels' launch counters are zeroed just before phase 7 and read
just after phase 9: every kernel but K6 must have launched on the main
path (one card takes no mesh).
They are zeroed again before phase 9b and read after it, before
phase 9c and after it (K2 must have launched in each), and before
phase 9d (a) and after it, and in the lifecycle child before and
after phase 9d (b) (K1 and K2 on phase 9d's path), and in each of
phase 17's children before its Runtime is built and after it stops (K1
and K2 in the cold boot, K2 in the warm one), and in phase 18's child
before (c) and after it (K1 and K2), and for each of phase 19's runs in
the process that evaluates it (its child for (a)-(c), the plane child
for (d) and (e)) before it and after it (K2 in (b) and (c)), and in
the plane child before phase 20 (b) and after (f) (K1, K2, K4, K5 and
K6), and in the scale child before phase 21 (a) and after (d) (K1, K2
and K6); the JSON line carries the nine counts, and K6's `launches` is
phase 20's.
The drivers of the phases before 15 compile in the foreground
(async_warm off), so their launch counts, paths and K5 patches are
deterministic, and they record their quarantines: each of those phases
fails if any kind was quarantined, since the interpreter would serve it
with the exact counts.
The smoke raises the collector's young threshold (GC_THRESHOLD) and
freezes what is alive at each phase boundary and after each ingest
(settle), as a long-lived server freezes its loaded heap; each phase's line gives its seconds in
the collector. Near the 1,200 s limit, the general audit's 40,000
objects and phase 15 (a)'s 25,000 pods are depth cuts already made, and
phases 15, 16, 9d (b), 12 and 17, phases 18, 19 and 20, and phase 21
run in three children beside phases 7-14; phase 19's export is cut to
50,000 manifests.

    python3 chip_smoke.py --mesh

runs phase 20 alone (its kernels built first),

    python3 chip_smoke.py --scale

runs phase 21 alone (its kernels built first), and

    python3 chip_smoke.py --kernels [K1,K2,K3,K4,K5,K6] [--root DIR] [--tune]

runs kernels alone, all six or those named (kernels_only: K3 at the
window of a 100,000-object general audit (general_window: its edit
round's regex window, twice the main path's, rebuilt once a call and
kept under _build/), config 4's 7
rows x its vocabulary and the hard set, each with its whole device
path's seconds; K4 at a 100,000-object general audit's shape, on
k4_audit_inputs and on k4_synthetic's tables; K5 at phase 13's shape,
K5_HOSTFS_LEAVES with 500 rows, with its whole patch path; K2 at the
flagship slab, the 21 corpus templates and config 6's 16 kinds at their
first-audit shapes, each bit-exact with its first-launch seconds, ms,
registers and spills; K1 on the flagship slab's words; K6 at phase
20's shard shapes on the flagship's words, its call and its whole
per-shard epilogue, whichever design the imported package has (k6_alone);
and a bare launch,
a 100,000-byte fill_), in
a Triton cache of its own, and prints one JSON line per kernel and a
summary line. --root imports the package of another checkout (e.g. the
parent commit unpacked with `git archive` under the gitignored
`_checkout/`), so that two commits run on one card in one call; --tune
times every K2 tile of TUNE_CONFIGS and every K4 LINE.

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
import contextlib
import gc
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
import weakref

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
GENERAL_RESULTS = {10_000: 332, 40_000: 1335}
# the same audit after GENERAL_EDIT at 40,000 objects (the JAX package's
# count, tests/torch_reference_counts.py 40000); its edit round keeps K3
# on the main path (its 2 regex rows then extend over about 60,000
# strings, past DEVICE_CROSSOVER's 100,000 evaluations). Cut from 50,000
# (1,662 and 1,662), and that from 100,000 (3,319 and 3,319), to keep
# the smoke inside its time limit
GENERAL_EDIT_RESULTS = {40_000: 1335}
GENERAL_EDIT = ("K8sContainerLimits", "limits-capped",
                {"cpu": "1", "memory": "1Gi"})
# BENCH config 6 (bench_configs.py config6): PSP library x 50,000 pods,
# 1% churn per round; 58,902 is BENCH_r07's count, the edit rounds' are
# the JAX package's (tests/torch_reference_counts.py --churn 50000)
CONFIG6_PODS = 50_000
CONFIG6_RESULTS = 58902
# phases 15 (a) and 16: config 6 at half its pods, to keep the smoke
# inside its time limit (the JAX package's count,
# tests/torch_reference_counts.py --churn 25000)
LIFECYCLE_PODS = 25_000
LIFECYCLE_RESULTS = 29448
CONFIG6_EDIT_RESULTS = 62494
CHURN_SUBSET = 2000
JOIN_KINDS = ("K8sUniqueIngressHost", "K8sUniqueServiceSelector")
JOIN_N = (512, 2048, 16_667, 40_000)  # host probe vs K4
# K4 alone (--kernels): k4_synthetic's (seed, len(u), G, N, hmax) at a
# 100,000-object general audit's N, Kb (32,768), G and H
K4_AUDIT = (0, 16_667, 1, 100_000, 1)
# K5 alone (--kernels): the feature leaves of config 6's widest kind,
# K8sPSPHostFilesystem, as (dtype, row shape), 400 row bytes in all: 12
# slots of 7 leaves; phase 13 checks them against the churn driver's
# leaves. Rows: the bucket of 50,000 candidates.
_HOSTFS_SLOT = ("int32", "float32", "int32", "int8", "int32", "float32",
                "int32")
K5_HOSTFS_LEAVES = [(d, s) for s in ((2,), (2,), (2,), (1,), (1, 1),
                                     (1, 1), (2,), (1, 1), (1,), (1, 1),
                                     (1, 1), (1, 1))
                    for d in _HOSTFS_SLOT]
K5_HOSTFS_ROWS = 65_536
TARGET = "admission.k8s.gatekeeper.sh"
# Python's cyclic collector as a long-lived server would run it: young
# collections every GC_THRESHOLD[0] net container allocations (Python's
# default is 700), and at each phase boundary and after each ingest what
# is alive frozen out of later scans (settle), as the JAX package's
# control plane freezes its heap once loaded (control/main.py). Under
# the defaults the collector took 28 of phase 9's 91 s (PERF.md)
GC_THRESHOLD = (50_000, 20, 10)


class Fail(Exception):
    pass


def settle(release: bool = False) -> None:
    """Collect the garbage of the phase that ended, then freeze what is
    still alive, so that later collections do not scan it. release:
    first unfreeze, so that objects frozen earlier and dropped since (a
    phase's drivers kept for a later phase) are collected too."""
    if release:
        gc.unfreeze()
    gc.collect()
    gc.freeze()


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


# every foreground_driver() (alive ones), and each quarantine any of
# them reported through on_quarantine: (kind, reason)
FOREGROUND = weakref.WeakSet()
QUARANTINED: list = []


def foreground_driver(mesh=None, device="cuda"):
    """A TorchDriver that compiles in the foreground (`async_warm` off),
    as the JAX package's own entry points pin it for deterministic
    dispatch: the phases before 15 hold launch counts, paths and K5's
    patches that a background warm would move. Its quarantines are
    recorded (no_quarantine): a kernel failure there would otherwise be
    served by the interpreter with the exact counts."""
    from gatekeeper_tpu_torch.ir import TorchDriver

    drv = TorchDriver(device=device, mesh=mesh)
    drv.async_warm = False
    drv.on_quarantine = lambda kind, reason: QUARANTINED.append(
        (kind, reason))
    FOREGROUND.add(drv)
    return drv


def no_quarantine(after: str) -> None:
    """Fail when any foreground driver quarantined a kind: the phases
    before 15 inject no fault, so that a kind went to the interpreter
    because a kernel failed on the card."""
    for t in threading.enumerate():
        if t.name.startswith("quarantine-note-"):
            t.join(10)  # on_quarantine runs off the serving thread
    benched = {k: v["reason"] for drv in list(FOREGROUND)
               for k, v in drv.quarantine_status().items()}
    hist = sorted({k for drv in list(FOREGROUND)
                   for k in drv._quarantine_hist})
    check(not QUARANTINED and not benched and not hist,
          f"a kind was quarantined by {after}: notified {QUARANTINED}, "
          f"benched {benched}, recovered {hist}")


def library_constraint(kind: str, name: str, params) -> dict:
    return {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind, "metadata": {"name": name},
            "spec": ({"parameters": params} if params else {})}


def library_client(driver, compiled_only: bool):
    from gatekeeper_tpu_torch.client import Backend
    from gatekeeper_tpu_torch.target import K8sValidationTarget

    return add_library(Backend(driver).new_client([K8sValidationTarget()]),
                       compiled_only)


def add_library(client, compiled_only: bool):
    """Phase 9's library (the 23 shipped templates and their
    constraints; compiled_only: the two joins left out) added to
    `client`, which it returns."""
    from gatekeeper_tpu_torch import policies
    from gatekeeper_tpu_torch.parallel.workload import (
        GENERAL_CONSTRAINTS, PSP_CONSTRAINTS)

    joins = {"general/uniqueingresshost": "K8sUniqueIngressHost",
             "general/uniqueserviceselector": "K8sUniqueServiceSelector"}
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


def gate_line(drv, before: dict) -> str:
    """The compiled kinds the cost model (_use_device_for_batch) kept on
    the host since the eval counts were `before`, and its EMAs."""
    after = drv.eval_counts()
    kept = sorted(k for k in drv._programs
                  if after.get((k, "interp"), 0) > before.get((k, "interp"),
                                                              0))
    lat = drv._dev_batch_lat_s
    return (f"cost model kept on the host: {kept or 'none'}; device "
            f"latency EMA {'unset' if lat is None else f'{lat:.6f} s'}, "
            f"host rate EMA {drv._host_pair_rate:.0f} pairs/s")


# the phases TorchDriver's audit records into profiling.timers(), at the
# JAX package's sites
AUDIT_PHASES = ("encode", "device_sweep", "materialize", "interp_eval",
                "delta_serve", "compile")


def phase_split(before: dict, wall: float) -> tuple[dict, str]:
    """An audit's seconds by phase since the profiling.timers() snapshot
    `before`, beside its wall clock: the record and a line. The parts
    leave out the host work between them (matching, dispatch, result
    assembly); a lazy launch's compile falls inside device_sweep."""
    from gatekeeper_tpu_torch.utils import profiling

    diff = profiling.PhaseTimers.diff(before, profiling.timers().snapshot())
    check(set(diff) <= set(AUDIT_PHASES), f"unknown audit phases {diff}")
    rec = {k: diff.get(k, 0.0) for k in AUDIT_PHASES}
    parts = sum(rec.values())
    line = (", ".join(f"{k} {v:.3f} s" for k, v in rec.items())
            + f"; the parts {parts:.3f} s of the wall clock {wall:.3f} s "
            f"({wall - parts:.3f} s outside them)")
    return {**rec, "parts_s": parts, "wall_s": wall}, line


def phase_build(report: dict) -> None:
    from gatekeeper_tpu_torch.kernels import join_member as k4
    from gatekeeper_tpu_torch.kernels import pair_compact as k1
    from gatekeeper_tpu_torch.kernels import regex_scan as k3
    from gatekeeper_tpu_torch.kernels import rows_update as k5
    from gatekeeper_tpu_torch.kernels import shard_counts as k6
    from gatekeeper_tpu_torch.kernels.build import build_all

    t0 = time.perf_counter()
    reports = build_all()
    log(f"[build] K1, K3, K4, K5, K6 nvcc sm_90a, in parallel: "
        f"{time.perf_counter() - t0:.2f} s")
    for name, ptxas in reports.items():
        for line in ptxas.splitlines():
            if "Used" in line or "spill" in line or \
                    "Compiling entry" in line:
                log(f"[build]   {name}: {line.strip()}")
    for mod in (k1, k3, k4, k5, k6):
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
    from gatekeeper_tpu_torch.target import K8sValidationTarget

    drv = foreground_driver()
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


def k3_args(dfas, strings, dev) -> tuple:
    """K3's arguments on the card, as the imported package's scan_device
    makes them: this checkout's packed strings and compressed tables
    (buf, offsets, blob, pdesc, gdesc, table_smem), or an earlier
    checkout's padded design (table, accept_end, start, matched_id,
    bytes), so that --root can time the parent."""
    from gatekeeper_tpu_torch.ir.carry import tree_from_numpy
    from gatekeeper_tpu_torch.ops import regex_nfa

    prep = regex_nfa.scan_prep(strings)
    check(prep is not None, "K3: the strings are not scannable")
    if hasattr(regex_nfa, "scan_tables"):
        from gatekeeper_tpu_torch.kernels.regex_scan import sm_count

        *tabs, smem = regex_nfa.scan_tables(dfas, len(strings),
                                            sm_count(dev))
        return (*tree_from_numpy((*prep[:2], *tabs), dev), smem)
    return tree_from_numpy(regex_nfa.stack_dfas(dfas)
                           + (regex_nfa.trim_bytes(prep[0]),), dev)


def scan_path(dfas, strings, dev):
    """MatchTables' whole device path: scan_prep, then scan_device
    (tables, upload, one K3 launch, download), in either design."""
    from gatekeeper_tpu_torch.ops import regex_nfa

    prep = regex_nfa.scan_prep(strings)
    return regex_nfa.scan_device(dfas, prep[:2] if len(prep) == 3
                                 else prep[0], dev)


def host_rows(patterns, strings) -> "np.ndarray":
    """The host path's rows: one compiled re.search per (row, string)."""
    import numpy as np

    out = np.zeros((len(patterns), len(strings)), dtype=bool)
    for i, p in enumerate(patterns):
        rx = re.compile(p)
        out[i] = np.fromiter((rx.search(s) is not None for s in strings),
                             dtype=bool, count=len(strings))
    return out


def k3_work(dfas, strings) -> tuple[float, float]:
    """(bytes, operations) one K3 launch needs on these inputs, counted
    from the DFAs and the strings alone (so one yardstick holds the
    parent and the change): a walk ends at the string's end, at the
    match sink or at the dead state (a state every byte leaves in place
    that neither matches nor accepts), so a string's bytes count only as
    far as its longest walk over the P patterns, plus one byte for its
    end when some walk is still live there (the NUL of a padded row; a
    packed layout's offsets are its own cost, not the function's); the
    compressed tables (classes, uint16 states over them, accept flags, 6
    int32 descriptors a pattern) and the output count once. Operations:
    5 a step taken (byte, class, index, state load, stop test), 3 a
    (pattern, string) for the verdict."""
    import numpy as np

    V, P = len(strings), len(dfas)
    lens = np.fromiter(map(len, strings), dtype=np.int64, count=V)
    L = int(lens.max()) if V else 0
    mat = np.zeros((V, max(L, 1)), dtype=np.uint8)
    if V and L:
        mat[:, :L] = np.frombuffer(np.array(strings, dtype=f"S{L}"),
                                   np.uint8).reshape(V, L)
    need = np.zeros(V, dtype=np.int64)  # bytes to the longest walk
    ends = np.zeros(V, dtype=bool)  # some walk live at the string's end
    steps = tables = 0
    for d in dfas:
        S = d.table.shape[0]
        ids = np.arange(S)
        n_cls = len(np.unique(d.table[:, 1:].T, axis=0))
        tables += 256 + 2 * S * n_cls + S + 24
        dead = (d.table[:, 1:] == ids[:, None]).all(axis=1) & \
            ~d.accept_end & (ids != d.matched)
        state = np.full(V, d.start, dtype=np.int64)
        live = np.full(V, d.start != d.matched and not dead[d.start])
        took = np.zeros(V, dtype=np.int64)
        for t in range(L):
            live &= t < lens
            took += live
            steps += int(live.sum())
            state = np.where(live, d.table[state, mat[:, t]], state)
            live &= (state != d.matched) & ~dead[state]
        # a walk that neither matched nor died reads the end
        ends |= (state != d.matched) & ~dead[state]
        need = np.maximum(need, took)
    return (float(need.sum() + ends.sum() + tables + P * V),
            float(5 * steps + 3 * P * V))


def time_k3(what: str, patterns, strings, dev, path_reps: int = 5) -> dict:
    """K3 on `patterns` x `strings` against its plain version, and
    against re.search on every string but those the host patches (NUL,
    \\x01, newline) (fatal); its time, the plain version's, the bound
    from k3_work, and the whole device path (scan_prep, then
    scan_device; host clock, median of `path_reps`). Launches made here
    are not counted."""
    import numpy as np
    import torch

    from gatekeeper_tpu_torch.kernels.regex_scan import (
        regex_scan, regex_scan_plain)
    from gatekeeper_tpu_torch.ops import regex_nfa

    launches = regex_scan.launches
    dfas = [regex_nfa.try_compile_device(p) for p in patterns]
    check(all(d is not None for d in dfas),
          f"K3 {what}: a pattern is outside the DFA subset")
    special = regex_nfa.scan_prep(strings)[-1]
    args = k3_args(dfas, strings, dev)
    got = regex_scan(*args)
    ref = regex_scan_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), f"K3 != plain on {what}")
    keep = np.ones(len(strings), dtype=bool)
    keep[special] = False
    want = host_rows(patterns, strings)
    check(np.array_equal(got.cpu().numpy()[:, keep], want[:, keep]),
          f"K3 != re.search on {what}")
    kms = cuda_ms(lambda: regex_scan(*args))
    pms = cuda_ms(lambda: regex_scan_plain(*args), reps=3, warmup=1)
    nbytes, ops = k3_work(dfas, strings)
    bms, by = bound_ms(nbytes, ops)
    reps = []
    for _ in range(path_reps):
        t0 = time.perf_counter()
        scan_path(dfas, strings, dev)
        reps.append(time.perf_counter() - t0)
    path_s = sorted(reps)[path_reps // 2]
    regex_scan.launches = launches
    log(f"[K3] {what} [{len(patterns)} x {len(strings)}]: bit-exact "
        f"({int(want.sum())} matches); kernel {kms:.4f} ms, plain "
        f"{pms:.4f} ms, bound {bms:.6f} ms ({by}: {nbytes:.0f} B, "
        f"{ops:.0f} ops), device path {path_s:.4f} s (host clock, median "
        f"of {path_reps})")
    return {"max_abs_err": 0, "ms": kms, "plain_ms": pms, "bound_ms": bms,
            "bound_by": by, "library_ms": None, "path_s": path_s}


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


def time_k4(what: str, args: tuple, fences: tuple) -> dict:
    """K4 on `args` (u_p, cnt_p, sik_p, karr, iks) against its plain
    version (fatal), its time as the main path calls it (with `fences`,
    the inventory's cached fences, where the package has them; empty for
    a package whose K4 takes none), the plain version's, the search alone
    through torch.searchsorted, and the bound from k4_work."""
    import torch

    from gatekeeper_tpu_torch.ir import join as tjoin
    from gatekeeper_tpu_torch.kernels.join_member import (
        join_member, join_member_plain)

    kp = tjoin.KEY_PAD
    u_p, cnt_p, sik_p, karr, iks = args
    got = join_member(*args, kp, *fences)
    ref = join_member_plain(*args, kp)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), f"K4 != plain on {what}")
    kms = cuda_ms(lambda: join_member(*args, kp, *fences))
    pms = cuda_ms(lambda: join_member_plain(*args, kp))
    lms = cuda_ms(lambda: torch.searchsorted(u_p, karr))
    N, H = karr.shape
    kb, G = u_p.shape[0], sik_p.shape[0]
    real = int((karr != kp).sum())
    nbytes, ops = k4_work(args, kp)
    bms, by = bound_ms(nbytes, ops)
    log(f"[K4] {what}: N {N}, H {H}, Kb {kb}, G {G}, {real} real keys, "
        f"{int(ref.sum())} fire: bit-exact; kernel {kms:.4f} ms, plain "
        f"{pms:.4f} ms, torch.searchsorted (search only) {lms:.4f} ms, "
        f"bound {bms:.6f} ms ({by}: {nbytes:.0f} B, {ops:.0f} ops)")
    return {"max_abs_err": 0, "ms": kms, "plain_ms": pms, "bound_ms": bms,
            "bound_by": by, "library_ms": lms}


def time_k5(what: str, resident: list, pos, rows: list) -> dict:
    """K5 writing `rows` (host arrays) at `pos` into copies of the device
    leaves `resident`, against its plain version (fatal, byte for byte,
    and the patch must change some leaf); its time, the plain version's,
    index_copy_'s per leaf, the bound (each row byte read once and
    written once, pos read once) and the whole patch path (stage, copy,
    K5) on the host clock, median of 21."""
    import torch

    from gatekeeper_tpu_torch.ir.carry import to_tensor
    from gatekeeper_tpu_torch.kernels.rows_update import (
        launch, rows_update, rows_update_plain, stage)

    dev = resident[0].device
    m = len(pos)
    got = [t.clone() for t in resident]
    ref = [t.clone() for t in resident]
    rows_update(got, pos, rows)
    pos_d = torch.from_numpy(pos).to(dev)
    rows_d = [to_tensor(r, dev).view(t.dtype) for r, t in zip(rows, ref)]
    rows_update_plain(ref, pos_d, rows_d)
    torch.cuda.synchronize()
    err = max(int((g.view(torch.uint8).int() - r.view(torch.uint8).int())
                  .abs().max()) for g, r in zip(got, ref))
    check(err == 0, f"K5 != plain on {what}")
    check(any(not torch.equal(g.view(torch.uint8), t.view(torch.uint8))
              for g, t in zip(got, resident)),
          f"K5's patch changed nothing on {what}")
    args = stage(got, pos, rows)
    kms = cuda_ms(lambda: launch(*args))
    pms = cuda_ms(lambda: rows_update_plain(ref, pos_d, rows_d))
    idx = pos_d.long()
    lms = cuda_ms(lambda: [d.index_copy_(0, idx, r)
                           for d, r in zip(ref, rows_d)])
    row_bytes = sum(r.nbytes for r in rows)
    nbytes = 2 * row_bytes + 4 * m
    bms, by = bound_ms(nbytes, 0)
    reps = []
    for _ in range(21):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows_update(got, pos, rows)
        torch.cuda.synchronize()
        reps.append(time.perf_counter() - t0)
    patch_ms = sorted(reps)[10] * 1e3
    log(f"[K5] {what}: {len(resident)} leaves, n_pad "
        f"{resident[0].shape[0]}, m {m}, {row_bytes} row bytes: bit-exact; "
        f"kernel {kms:.4f} ms, plain {pms:.4f} ms, index_copy_ {lms:.4f} "
        f"ms, bound {bms:.6f} ms ({by}: {nbytes} B); patch path (stage, "
        f"copy, K5; host clock, median of 21) {patch_ms:.3f} ms")
    return {"max_abs_err": err, "ms": kms, "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "library_ms": lms,
            "patch_path_ms": patch_ms}


def measure_crossover(what: str, pats: list[str], strings: list[str],
                      dev) -> dict:
    """MatchTables' two ways to build `pats`' rows over a vocab window:
    the host re.search loop, and the device path (scan_path: scan_prep,
    then scan_device: tables, upload, one K3 launch, download).
    Break-even = the device path's time x the host's evaluations per
    second. Launches made here are not counted."""
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
        check(regex_nfa.scan_prep(strings) is not None,
              f"{what}: the window is not scannable")
        prep_calls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        scan_path(dfas, strings, dev)
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
        f"({rate:.0f}/s), device path {dev_s:.4f} s (scan_prep alone "
        f"{prep_s:.4f} s), medians of 3; break-even "
        f"{dev_s * rate:.0f} evaluations; DEVICE_CROSSOVER "
        f"{regex_nfa.DEVICE_CROSSOVER}")
    return out


def phase_k3(dev, report: dict, flag_drv, lib_drv) -> None:
    from gatekeeper_tpu_torch.kernels import regex_scan as k3
    from gatekeeper_tpu_torch.ops import regex_nfa
    from gatekeeper_tpu_torch.ops.strtab import MatchTables
    from tests.torch_kernel_cases import (
        EDGE_LENGTHS, HARD_PATTERNS, K3_BIG_PATTERNS, big_vocab, hard_vocab)

    # config 4: the flagship setup's 7 allowedRegex rows x its vocabulary
    pats = [p for op, p in flag_drv.match_tables._patterns
            if op == "re_match"]
    check(len(pats) == 7, f"config 4 has {len(pats)} regex rows, want 7")
    strings = vocab(flag_drv.strtab)
    report["K3_config4"] = time_k3("config 4", pats, strings, dev)
    report["K3_crossover"] = {"config 4": measure_crossover(
        "config 4", pats, strings, dev)}

    # the library's regex and glob rows x the fleet-scan corpus vocabulary
    rows = [(op, p) for op, p in lib_drv.match_tables._patterns
            if op in ("re_match", "glob")]
    check(len(rows) > 0, "the library registered no regex rows")
    lib_pats = [MatchTables.glob_regex(p) if op == "glob" else p
                for op, p in rows]
    time_k3("library rows x corpus", lib_pats, vocab(lib_drv.strtab), dev,
            path_reps=1)

    # the hard set: every edge length, P*V not a multiple of the block
    hard = hard_vocab(7, 1001)
    check((len(HARD_PATTERNS) * len(hard)) % 256 != 0, "hard set aligned")
    time_k3("hard set", HARD_PATTERNS, hard, dev, path_reps=1)
    for k in EDGE_LENGTHS:
        one = [("ab" * 64)[:k], "a" * k, "x" * max(k - 1, 0) + "z"[:k]]
        time_k3(f"hard set, length {k}", HARD_PATTERNS, one, dev,
                path_reps=1)

    # patterns too large to share a block's shared memory: groups split
    # by size, and one group read from global memory
    # (200,000 strings: groups cut by size alone)
    big, strings = K3_BIG_PATTERNS + HARD_PATTERNS, big_vocab(8, 200_000)
    gdesc = regex_nfa.scan_tables(
        [regex_nfa.try_compile_device(p) for p in big], len(strings),
        k3.sm_count(dev))[2]
    check((gdesc[:, 3] > k3.GROUP_TABLE_BYTES).sum() == 1 and
          len(gdesc) >= 4 and gdesc[:, 1].max() > 1,
          f"the big set's groups {gdesc.tolist()}")
    time_k3("big patterns (a group from global memory)", big, strings, dev,
            path_reps=1)


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


def flagship(driver, n: int):
    """Config 4's client: requiredlabels, CONFIG4's 500 constraints, n
    Namespaces (1% violating)."""
    from gatekeeper_tpu_torch.client import Backend
    from gatekeeper_tpu_torch.parallel.workload import (
        REQUIRED_LABELS_TEMPLATE, synth_constraints, synth_objects)
    from gatekeeper_tpu_torch.target import K8sValidationTarget

    client = Backend(driver).new_client([K8sValidationTarget()])
    client.add_template(REQUIRED_LABELS_TEMPLATE)
    for c in synth_constraints(CONFIG4[1], seed=1):
        client.add_constraint(c)
    for o in synth_objects(n, violate_frac=0.01, seed=0):
        client.add_data(o)
    return client


def phase_audit(dev, report: dict) -> None:
    from gatekeeper_tpu_torch.client import RegoDriver
    from gatekeeper_tpu_torch.utils import profiling
    from gatekeeper_tpu_torch.kernels.clause import clause_words
    from gatekeeper_tpu_torch.kernels.pair_compact import pair_compact
    from gatekeeper_tpu_torch.kernels.regex_scan import regex_scan

    t0 = time.perf_counter()
    drv = foreground_driver()
    client = flagship(drv, CONFIG4[0])
    log(f"[audit] config 4 ingest ({CONFIG4[1]} constraints, {CONFIG4[0]} "
        "objects): "
        f"{time.perf_counter() - t0:.1f} s")
    settle()
    before = clause_words.launches, pair_compact.launches
    k3_before = regex_scan.launches
    counts0 = drv.eval_counts()
    timers0 = profiling.timers().snapshot()
    t0 = time.perf_counter()
    res = client.audit().results()
    first = time.perf_counter() - t0
    split, split_line = phase_split(timers0, first)
    log(f"[audit] config 4 first audit: {gate_line(drv, counts0)}")
    log(f"[audit] config 4 first audit by phase: {split_line}")
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
                       "steady_s": steady, "first_phases": split}

    sub_t = flagship(foreground_driver(), SUBSET)
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
    the 40,000-object driver (its K3 and K4 inputs feed phase 11) and the
    10,000-object one with its client (phase 9b's previews)."""
    from gatekeeper_tpu_torch.kernels.join_member import join_member
    from gatekeeper_tpu_torch.kernels.regex_scan import regex_scan
    from gatekeeper_tpu_torch.parallel.workload import synth_mixed_objects

    from gatekeeper_tpu_torch.ops import regex_nfa
    from gatekeeper_tpu_torch.ops.strtab import MatchTables

    big = None
    for n, want in GENERAL_RESULTS.items():
        t0 = time.perf_counter()
        drv = foreground_driver()
        client = general_client(drv)
        for o in synth_mixed_objects(n):
            client.add_data(o)
        ingest = time.perf_counter() - t0
        settle()
        k4, k3 = join_member.launches, regex_scan.launches
        counts0 = drv.eval_counts()
        t0 = time.perf_counter()
        res = client.audit().results()
        first = time.perf_counter() - t0
        log(f"[general] {n} objects, first audit: "
            f"{gate_line(drv, counts0)}")
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
            counts0 = drv.eval_counts()
            t0 = time.perf_counter()
            res3 = client.audit().results()
            edit = time.perf_counter() - t0
            k3_edit = regex_scan.launches - k3
            log(f"[general] {n} objects, edit round: "
                f"{gate_line(drv, counts0)}")
            # a device sweep extends every pending row; none, when the
            # cost model kept every kind on the host
            extended = all(mt._built_len[r] >= V for r, _b in pend)
            check(len(res3) == GENERAL_EDIT_RESULTS[n],
                  f"general edit round of {n} returned {len(res3)} "
                  f"results, want {GENERAL_EDIT_RESULTS[n]}")
            check(drv.last_audit_path == "single(cuda)",
                  f"general edit round of {n} took {drv.last_audit_path}")
            check((k3_edit > 0) == (
                extended and evals >= regex_nfa.DEVICE_CROSSOVER),
                  f"general edit round of {n}: {evals} regex evaluations, "
                  f"DEVICE_CROSSOVER {regex_nfa.DEVICE_CROSSOVER}, rows "
                  f"extended {extended}, K3 launches {k3_edit}")
            line += (f"; edit round {edit:.3f} s, {len(res3)} results, K3 "
                     f"{k3_edit} launches ({len(pats)} regex rows x "
                     f"{len(window)} new strings; vocab {V})")
            rec.update(edit_s=edit, edit_results=len(res3))
        log(line)
        report[f"general_{n}"] = rec
        if n == min(GENERAL_RESULTS):
            small = (drv, client)
        big = (drv, client, pats, window)
    return big, small


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
        for driver in (foreground_driver(), RegoDriver()):
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
    """K3 against its plain version and re.search, and its time, at the
    shape the main path launched it (the general 40,000-object edit
    round's window), and the same window against the patterns too large
    to share one block's shared memory."""
    from tests.torch_kernel_cases import K3_BIG_PATTERNS

    report["K3"] = time_k3("main-path shape", pats, window, dev)
    time_k3("main-path window x big patterns", K3_BIG_PATTERNS + pats,
            window, dev, path_reps=1)


def phase_k4_shapes(dev, report: dict, big) -> None:
    """K3 and K4 at the 40,000-object audit's own inputs, and the host
    probe against K4 over growing candidate lists."""
    drv, _client, pats, window = big
    n = max(GENERAL_RESULTS)
    phase_k3_path(dev, report, pats, window)
    inv = drv._inventory_tree(TARGET)
    reviews = drv._inventory_reviews(TARGET)
    rev_cache = drv._join_frz[1]
    frz = [rev_cache[id(r)][1] for r in reviews if id(r) in rev_cache]
    times = {}
    for kind in JOIN_KINDS:
        jc = drv.join_for(kind)
        args = jc._dev_inv_cache[0][2] + jc._dev_rev_cache[0][2]
        fences = jc._dev_inv_cache[0][3]
        times[kind] = time_k4(f"{kind} at {n:,} objects", args,
                              (fences,))
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
    from gatekeeper_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    drv = foreground_driver()
    pods = synth_pods_psp(CONFIG6_PODS)
    client = psp_client(drv, pods)
    log(f"[churn] config 6 ingest ({CONFIG6_PODS} pods, 16 templates): "
        f"{time.perf_counter() - t0:.1f} s")
    settle()
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
    # the gate as it would decide under the JAX package's audit samples
    # (dispatch to first result, later kinds' host work inside): a shadow
    # of the cost model's state fed those samples, asked at every gate
    # call the driver makes (TorchDriver._use_device_for_batch itself)
    shadow = types.SimpleNamespace(
        _dev_batch_lat_s=None, _host_pair_rate=drv._host_pair_rate,
        _dev_skips=0, PROBE_FLOOR_S=drv.PROBE_FLOOR_S)
    asked: list = []
    gate = drv._use_device_for_batch

    def asking(n):
        shadow._host_pair_rate = drv._host_pair_rate
        asked.append(TorchDriver._use_device_for_batch(shadow, n))
        return gate(n)

    drv._use_device_for_batch = asking
    try:
        for step, round_, edit in CHURN_STEPS:
            churn_step(client, drv, pods, rng, count, round_, edit)
            want_k5 = dirty_kinds(drv) if step in ("E1", "E2") else 0
            extracts[0] = 0
            k5 = rows_update.launches
            counts0 = drv.eval_counts()
            asked.clear()
            if step == "first":
                evaltorch.clause_words = k2_recording
            timers0 = profiling.timers().snapshot()
            t0 = time.perf_counter()
            try:
                res = client.audit().results()
            finally:
                evaltorch.clause_words = k2_orig
            el = time.perf_counter() - t0
            if step == "first":
                rec["first_phases"], split_line = phase_split(timers0, el)
                log(f"[churn] first audit by phase: {split_line}")
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
            lat = drv.last_audit_lat_s
            if lat is not None and lat[0] is not None:  # as the port drops
                TorchDriver._observe(shadow, "_dev_batch_lat_s", lat[1])
            ref_host = sum(not a for a in asked)
            log(f"[churn] {step}: {len(res)} results, {el:.3f} s, path "
                f"{path}{extra}; {gate_line(drv, counts0)}; latency sample "
                f"{'none' if lat is None else lat[0]} s, the reference's "
                f"{'none' if lat is None else lat[1]} s; under the "
                f"reference's samples the gate keeps {ref_host} of "
                f"{len(asked)} kinds on the host (EMA then "
                f"{shadow._dev_batch_lat_s} s)")
            rec[step] = {"results": len(res), "s": el,
                         "lat_sample_s": lat,
                         "reference_gate_host": ref_host}
    finally:
        del drv._use_device_for_batch
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
                  cache=None, aot=None):
        key = (id(cache), tuple(tuple(a.shape) for arrs in feats.values()
                                for a in arrs.values()))
        fresh = key not in seen
        t0 = time.perf_counter()
        out = orig(plans, feats, params, table, derived, chunk=chunk,
                   cache=cache, aot=aot)
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
    from gatekeeper_tpu_torch.ir import evaltorch
    from gatekeeper_tpu_torch.parallel.workload import synth_pods_psp

    drv = foreground_driver()
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


def k4_audit_inputs(n_keys: int = 16_667, n: int = 100_000) -> tuple:
    """Join tables shaped as a 100,000-object general audit's (phase 11
    takes them at 40,000): n_keys unique keys from a seed (Kb 32,768), each held by one
    object whose review carries it as its one key (H 1) with its own
    identity (G 1); the other reviews carry none. Nothing fires, as in
    the audit."""
    import numpy as np

    from gatekeeper_tpu_torch.ir import join as tjoin

    rng = np.random.default_rng(4)
    u = np.sort(rng.choice(40 * n_keys, n_keys, replace=False)) + 10
    sik = rng.integers(100, 1 << 20, (1, n_keys))
    iks = rng.integers(100, 1 << 20, (n, 1))
    keys = [[] for _ in range(n)]
    for j, r in enumerate(rng.choice(n, n_keys, replace=False).tolist()):
        keys[r] = [int(u[j])]
        iks[r, 0] = sik[0, j]
    return tjoin.pad_inventory(u, np.ones(n_keys, np.int32), sik) + \
        tjoin.pad_reviews(keys, iks, 1)


def k4_alone(dev) -> dict:
    """K4 (time_k4) at the general audit's shape on k4_audit_inputs, the
    line's entry, and on k4_synthetic's tables (K4_AUDIT: 49,896 real
    keys, 20,911 fire); the first also called as the parent commit calls
    it, with no fences (then built in the call)."""
    from gatekeeper_tpu_torch.ir import join as tjoin
    from gatekeeper_tpu_torch.ir.carry import tree_from_numpy
    from gatekeeper_tpu_torch.kernels import join_member as k4
    from tests.torch_kernel_cases import k4_synthetic

    def fences(args):
        # as the main path caches them, where the package has them
        return (k4.join_fences(args[0]),) if hasattr(k4, "join_fences") \
            else ()

    audit = tree_from_numpy(k4_audit_inputs(), dev)
    rec = time_k4("audit-shaped", audit, fences(audit))
    synth = tree_from_numpy(k4_synthetic(*K4_AUDIT), dev)
    syn = time_k4(f"k4_synthetic{K4_AUDIT}", synth, fences(synth))
    rec.update(synthetic_ms=syn["ms"], synthetic_bound_ms=syn["bound_ms"],
               ms_no_fences=cuda_ms(
                   lambda: k4.join_member(*audit, tjoin.KEY_PAD)))
    log(f"[K4] audit-shaped, called with no fences: "
        f"{rec['ms_no_fences']:.4f} ms")
    return rec


def k5_alone(dev) -> dict:
    """K5 at phase 13's shape (time_k5): K5_HOSTFS_LEAVES of
    K5_HOSTFS_ROWS random rows on the card, 500 positions among the
    first 50,000 and their rows from a seed."""
    import numpy as np

    from gatekeeper_tpu_torch.ir.carry import to_tensor

    rng = np.random.default_rng(6)

    def rand(shape, dtype):
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        return rng.integers(0, 256, n, dtype=np.uint8).view(dtype).reshape(
            shape)

    m = CONFIG6_PODS // 100
    resident = [to_tensor(rand((K5_HOSTFS_ROWS,) + s, d), dev)
                for d, s in K5_HOSTFS_LEAVES]
    pos = np.sort(rng.choice(CONFIG6_PODS, m, replace=False)).astype(
        np.int32)
    rows = [rand((m,) + s, d) for d, s in K5_HOSTFS_LEAVES]
    return time_k5("K5_HOSTFS_LEAVES", resident, pos, rows)


def k6_alone(dev) -> dict:
    """K6 alone at phase 20's shard shapes on config 4's verdict words
    (the flagship's first 32,768 rows, as (g) takes them): (g)'s [32,768,
    16], c 500, into the second shard's block of a [131,072, 500] fires,
    and (e)'s [32,768, 8], c 250, at column 250 of it. Times the kernel
    call and the whole per-shard epilogue as the imported package's
    make_audit_step runs it: one K6 call that writes the block (this
    design), or, where the package has the earlier design
    (collectives._unpack), a memset + K6 call for the counts, then the
    unpack, the row mask and the copy into fires."""
    import inspect

    import torch

    from gatekeeper_tpu_torch.kernels import shard_counts as k6
    from gatekeeper_tpu_torch.kernels.clause import clause_words
    from gatekeeper_tpu_torch.parallel import collectives

    n_loc = MESH_BUCKET // MESH_DATA[0]
    _drv, plans, feats, params, table, derived = flagship_inputs(dev)
    words = clause_words(plans, slab_of(feats, n_loc), params, table,
                         derived, cache={}).contiguous()
    del feats
    fused = "fires" in inspect.signature(k6.shard_counts).parameters
    fires = torch.empty((MESH_BUCKET, CONFIG4[1]), dtype=torch.bool,
                        device=dev)
    rec = {"design": "one launch" if fused else "memset + K6 + unpack"}
    c = CONFIG4[1]
    for shape, w_, cc, col in (("g", words, c, 0),
                               ("e", words[:, :8].contiguous(), c // 2,
                                c // 2)):
        rows, cols = slice(n_loc, 2 * n_loc), slice(col, col + cc)
        out = torch.zeros((cc,), dtype=torch.int32, device=dev)
        if fused:
            def call(w_=w_, cc=cc, rows=rows, cols=cols, out=out):
                k6.shard_counts(w_, 0, n_loc, cc, fires[rows, cols], out)
            epilogue = call
        else:
            def call(w_=w_, cc=cc, out=out):
                k6.shard_counts(w_, 0, n_loc, cc, out)

            def epilogue(w_=w_, cc=cc, rows=rows, cols=cols, out=out):
                k6.shard_counts(w_, 0, n_loc, cc, out)
                bits = collectives._unpack(w_, cc)
                bits[n_loc:] = False
                fires[rows, cols] = bits
        rec[f"{shape}_kernel_ms"] = cuda_ms(call)
        rec[f"{shape}_epilogue_ms"] = cuda_ms(epilogue)
        rec[f"{shape}_kernels_per_call"] = device_kernels(epilogue)
        log(f"[K6] ({shape}) [{n_loc}, {w_.shape[1]}] c {cc} at column "
            f"{col}, {rec['design']}: call {rec[f'{shape}_kernel_ms']:.5f} "
            f"ms, per-shard epilogue {rec[f'{shape}_epilogue_ms']:.5f} ms "
            f"({rec[f'{shape}_kernels_per_call']} device kernels)")
    part = torch.zeros((c,), dtype=torch.int32, device=dev)
    rec["zero_partial_ms"] = cuda_ms(lambda: part.zero_())
    return rec


def general_window(n: int = 100_000) -> tuple:
    """A K3 window as phase 8's edit round scans it (there at 40,000
    objects): (patterns, strings) that the general audit of n objects
    leaves pending after its first audit. Rebuilt through the imported package's
    TorchDriver once (about two minutes at 100,000 objects) and kept
    under this checkout's _build/, so that the runs of one --kernels
    call share it."""
    path = os.path.join(ROOT, "gatekeeper_tpu_torch", "_build",
                        f"k3_window_{n}.json")
    if os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        return rec["patterns"], rec["window"]
    from gatekeeper_tpu_torch.ops.strtab import MatchTables
    from gatekeeper_tpu_torch.parallel.workload import synth_mixed_objects

    t0 = time.perf_counter()
    drv = foreground_driver()
    client = general_client(drv)
    for o in synth_mixed_objects(n):
        client.add_data(o)
    client.audit()
    mt, V = drv.match_tables, len(drv.strtab)
    pend = [(r, mt._built_len[r]) for r, (op, _p) in enumerate(mt._patterns)
            if op in ("re_match", "glob") and mt._built_len[r] < V]
    check(len({b for _r, b in pend}) == 1, f"general window: {pend}")
    pats = [MatchTables.glob_regex(p) if op == "glob" else p
            for op, p in (mt._patterns[r] for r, _b in pend)]
    window = mt._window(pend[0][1], V)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".tmp", "w") as f:
        json.dump({"patterns": pats, "window": window}, f)
    os.replace(path + ".tmp", path)
    log(f"[K3] general window of {n} objects rebuilt: {len(pats)} rows x "
        f"{len(window)} strings, {time.perf_counter() - t0:.1f} s")
    return pats, window


def k3_alone(dev) -> list:
    """K3 (time_k3) at a 100,000-object general audit's window
    (general_window), config
    4's 7 rows x its vocabulary (build_eval_setup at full size) and the
    hard set, each as (case, record)."""
    from gatekeeper_tpu_torch.parallel.workload import build_eval_setup
    from tests.torch_kernel_cases import HARD_PATTERNS, hard_vocab

    out = [("main", time_k3("main-path window", *general_window(), dev))]
    flag = build_eval_setup(*CONFIG4, device=dev.type)[0]
    pats = [p for op, p in flag.match_tables._patterns if op == "re_match"]
    out.append(("config4", time_k3("config 4", pats, vocab(flag.strtab),
                                   dev)))
    out.append(("hard", time_k3("hard set", HARD_PATTERNS,
                                hard_vocab(7, 1001), dev)))
    return out


def kernels_only(dev, tune: bool, tag: str, which: set) -> None:
    """Kernels alone (`which` of K1-K6), for comparing two checkouts
    (--root) or K2's tiles and K4's LINE (--tune) on one card: K3 at the
    main path's window, config 4's rows and the hard set (k3_alone); K4
    at the general audit's shape (k4_alone); K5 at phase 13's
    (k5_alone); K6 at phase 20's shard shapes with its whole per-shard
    epilogue (k6_alone); K2 at the flagship slab, the 21 corpus
    templates and config 6's 16 kinds at their first-audit shapes; K1 on
    the flagship slab's words; each against its plain version; and the
    floor of any launch. Uses only entry points that every slice of the
    port has.
    Prints one JSON line per kernel and one summary line per run (per K2
    tile with --tune)."""
    import torch

    from gatekeeper_tpu_torch.kernels import clause_triton
    from gatekeeper_tpu_torch.kernels.clause import clause_words

    # the floor of any launch: one that only writes 100,000 bytes
    floor = torch.empty(100_000, dtype=torch.uint8, device=dev)
    out = {"root": tag, "launch_floor_ms": cuda_ms(lambda: floor.fill_(1))}
    log(f"[floor] fill_ of 100,000 bytes: {out['launch_floor_ms']:.4f} ms")
    if "K3" in which and not tune:
        for case, rec in k3_alone(dev):
            print(json.dumps(dict(rec, kernel="K3", case=case, root=tag)))
            out.update({f"k3_{case}_{k}": rec[k] for k in
                        ("ms", "plain_ms", "bound_ms", "path_s")})
    for name, alone in (("K4", k4_alone), ("K5", k5_alone),
                        ("K6", k6_alone)):
        if name in which and not tune:
            rec = alone(dev)
            print(json.dumps(dict(rec, kernel=name, root=tag)))
            out.update({f"{name.lower()}_{k}": v for k, v in rec.items()
                        if k.endswith("ms")})
    if "K4" in which and tune:
        from gatekeeper_tpu_torch.kernels import join_member as k4

        for line in k4.LINES:
            k4.LINE = line
            rec = k4_alone(dev)
            print(json.dumps(dict(rec, kernel="K4", root=tag, line=line)))
    if not {"K1", "K2"} & which:
        print(json.dumps(out))
        return
    t0 = time.perf_counter()
    _drv, plans, feats, params, table, derived = flagship_inputs(dev)
    flag = (plans, (slab_of(feats), params, table, derived))
    del feats
    entries = [("flagship", *flag, None)]
    if "K2" in which:
        _cdrv, corp = corpus_k2_inputs()
        entries += [(f"corpus:{k}", p, ins, None) for k, p, ins in corp]
        entries += [(f"config6:{k}", p, ins, first) for k, p, ins, first
                    in config6_k2_inputs()]
    setup_s = time.perf_counter() - t0

    def summary(recs) -> dict:
        by: dict = {}
        for r in recs:
            by.setdefault(r["name"].split(":")[0], []).append(r)
        return {**out, "setup_s": setup_s,
                "k2_flagship_ms": by["flagship"][0]["ms"],
                **{f"k2_{g}_ms_sum": sum(r["ms"] for r in v)
                   for g, v in by.items() if g != "flagship"},
                **{f"k2_{g}_first_s_sum": sum(r["first_s"] for r in v)
                   for g, v in by.items()},
                "all_exact": all(r["exact"] for r in recs),
                "max_regs": max((r["n_regs"] or 0) for r in recs),
                "spills": sum((r["n_spills"] or 0) for r in recs)}

    if not tune:
        if "K2" in which:
            recs = [time_k2(*e) for e in entries]
            for r in recs:
                print(json.dumps(dict(r, kernel="K2", root=tag)))
            out = summary(recs)
        if "K1" in which:
            words = clause_words(flag[0], *flag[1], cache={})
            k1 = time_k1_slab(words.contiguous(), CONFIG4[1])
            print(json.dumps(dict(k1, kernel="K1", root=tag)))
            out.update(k1_ms=k1["ms"],
                       k1_kernels_per_call=k1["kernels_per_call"])
        print(json.dumps(out))
        return
    if "K2" not in which:
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
    from gatekeeper_tpu_torch.parallel.workload import (
        CHURN_STEPS, churn_step, synth_pods_psp)

    pods = synth_pods_psp(CHURN_SUBSET)
    sides = []
    for driver in (foreground_driver(), RegoDriver()):
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
    every feature leaf of the kind with the widest rows (whose leaves
    must be K5_HOSTFS_LEAVES, the --kernels shape), n_pad its bucket; its
    time, index_copy_'s, and the whole patch path (stage, copy, K5)
    against a full re-upload of the kind's leaves."""
    import numpy as np
    import torch

    from gatekeeper_tpu_torch.ir.carry import to_tensor

    def leaves(kind):
        feats = drv._feat_cache[kind]["__meta__"]["feats"]
        return [a for arrs in feats.values() for a in arrs.values()]

    kind = max(drv._feat_cache, key=lambda k: sum(
        a.nbytes // a.shape[0] for a in leaves(k)))
    host = leaves(kind)
    widths = [(str(a.dtype), tuple(a.shape[1:])) for a in host]
    check(kind == "K8sPSPHostFilesystem" and widths == K5_HOSTFS_LEAVES
          and host[0].shape[0] == K5_HOSTFS_ROWS,
          f"config 6's widest kind {kind} ({len(host)} leaves, n_pad "
          f"{host[0].shape[0]}) is not K5_HOSTFS_LEAVES")
    n = len(drv._feat_cache[kind]["__meta__"]["cand"])
    m = CONFIG6_PODS // 100
    rng = np.random.default_rng(6)
    pos = np.sort(rng.choice(n, m, replace=False)).astype(np.int32)
    # rows taken from other pods, so that the patch changes the leaves
    rows = [a[rng.choice(n, m, replace=False)] for a in host]
    rows = [r.view(np.int32) if r.dtype == np.uint32 else r for r in rows]
    resident = [drv._dev_cache[id(a)][1] for a in host]
    rec = time_k5(f"config 6's {kind}", resident, pos, rows)
    reps = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        [to_tensor(a, dev) for a in host]
        torch.cuda.synchronize()
        reps.append(time.perf_counter() - t0)
    full_ms = sorted(reps)[2] * 1e3
    full_bytes = sum(a.nbytes for a in host)
    log(f"[K5] full re-upload of {kind}'s {full_bytes} B: {full_ms:.3f} ms "
        f"(host clock, median of 5)")
    patch_ms = rec.pop("patch_path_ms")
    report["K5"] = rec
    report["K5_path"] = {"kind": kind, "leaves": len(host), "m": m,
                         "n_pad": int(host[0].shape[0]),
                         "patch_path_ms": patch_ms,
                         "full_reupload_ms": full_ms,
                         "full_reupload_bytes": full_bytes}


def phase_batches(dev, report: dict) -> tuple:
    """Each review batch once as the cost model decides (per kind the
    path taken, then the EMAs) and once with the device pinned
    (_dev_batch_lat_s = 1e-4, as the JAX package's tests pin it), both
    equal to the interpreter; pinned, every compiled kind with masked
    pairs takes the device, K2 launches, and the sparse branch K1.
    Returns the driver, its client, and the dense batch's manifests with
    the interpreter's (enforcement action, message) pairs per manifest
    (phase 9b)."""
    from batch_profile import GcClock
    from gatekeeper_tpu_torch.client import RegoDriver
    from gatekeeper_tpu_torch.kernels.clause import clause_words
    from gatekeeper_tpu_torch.kernels.pair_compact import pair_compact

    drv = foreground_driver()
    client = library_client(drv, compiled_only=False)
    oracle = library_client(RegoDriver(), compiled_only=False)
    # the corpus as inventory, so the join kinds have objects to join
    for o in corpus(2000):
        client.add_data(o)
        oracle.add_data(o)
    gc_clock = GcClock()
    for n, branch in BATCHES:
        objs = corpus(n)
        responses = oracle.review_batch(objs)
        want = [result_key(r.results()) for r in responses]
        settle()
        if branch == "dense":
            served = (drv, client, objs,
                      [[(r.enforcement_action, r.msg) for r in resp.results()]
                       for resp in responses])
        for mode in ("cost model", "pinned"):
            if mode == "pinned":
                drv._dev_batch_lat_s = 1e-4
            before = clause_words.launches, pair_compact.launches
            counts0 = drv.eval_counts()
            gc_clock.read()
            t0 = time.perf_counter()
            got = client.review_batch(objs)
            first = time.perf_counter() - t0
            gc_s = gc_clock.read()["gc_s"]
            gk = [result_key(r.results()) for r in got]
            check(gk == want, f"review batch of {n} ({mode}) differs from "
                  "the interpreter")
            k2 = clause_words.launches - before[0]
            k1 = pair_compact.launches - before[1]
            counts = drv.eval_counts()
            paths: dict = {}
            for (kind, path), c in counts.items():
                if c > counts0.get((kind, path), 0):
                    paths.setdefault(path, []).append(kind)
            log(f"[batch] {n} manifests ({branch}, {mode}): "
                f"{sum(len(k) for k in gk)} results equal the interpreter; "
                f"{first:.3f} s ({gc_s:.3f} s of it in Python's garbage "
                f"collector); launches K2 {k2}, K1 {k1}; per kind: "
                + "; ".join(f"{p} {sorted(ks)}" for p, ks in
                            sorted(paths.items()))
                + f"; device latency EMA {drv._dev_batch_lat_s}, host rate "
                f"EMA {drv._host_pair_rate:.0f} pairs/s")
            report.setdefault(f"batch_{n}", {})[mode] = {
                "s": first, "gc_s": gc_s,
                "device_kinds": len(paths.get("device", [])),
                "host_kinds": len(paths.get("interp", [])),
                "dev_batch_lat_s": drv._dev_batch_lat_s,
                "host_pair_rate": drv._host_pair_rate}
            if mode == "pinned":
                check(k2 > 0, f"batch of {n}: K2 never launched")
                if branch == "sparse":
                    check(k1 > 0, f"batch of {n}: K1 never launched")
                check(not paths.get("interp"),
                      f"batch of {n} pinned: kinds served by the "
                      f"interpreter: {paths.get('interp')}")
    gc_clock.stop()
    check(drv.fallback_reasons() == {}, "a compiled kind fell back")
    check(len(drv.compiled_kinds()) == 23, "expected 23 device kinds")
    demoted = [k for k in drv._programs
               if drv._compiled.get(k, True) is None]
    check(not demoted, f"demoted kinds: {demoted}")
    counts = drv.eval_counts()
    check(all(counts.get((k, "join"), 0) for k in JOIN_KINDS),
          f"a join kind took no join evaluation: {counts}")
    return served


# phase 9b: the admission webhook (WebhookServer -> ValidationHandler ->
# MicroBatcher -> TorchDriver.review_batch) over loopback HTTP, loaded by
# WEBHOOK_CLIENTS keep-alive connections in a child process of this script
WEBHOOK_CLIENTS = 32
# the API server's webhook timeout, as it sends it (?timeout=): its
# longest, 30 s, so that only a stall (an inline compile: about 0.6 s a
# K2 variant, up to 21 in one batch) can pass it
WEBHOOK_PATH = "/v1/admit?timeout=30s"
WEBHOOK_PASSES = ("cost model", "pinned, cold", "pinned, warm")
# batch sizes, one of each row-count class K2 specializes on, reviewed
# after the cold pass so that the warm pass finds every class compiled
WARM_ROW_CLASSES = (1, 3, 16)
# the previews' candidates at the general library's 10,000 objects: a
# review-pure kind (K2 + K1) and a join kind, with the path each must take
PREVIEWS = (("K8sRequiredLabels",
             {"labels": [{"key": "app", "allowedRegex": "^app[0-9]$"}]},
             "device"),
            ("K8sUniqueIngressHost", None, "join"))


def loadgen(spec_path: str) -> None:
    """The load generator (`--loadgen FILE`, phase 9b's child): POSTs
    each body of FILE's "bodies" to FILE's "path" on FILE's "port" over
    FILE's "clients" keep-alive connections at once, each sending its
    next request when the last one's response is read, and writes
    FILE.out: per request (status, body, latency s), and the wall clock
    from the first send to the last response."""
    import http.client
    from concurrent.futures import ThreadPoolExecutor

    with open(spec_path) as f:
        spec = json.load(f)
    bodies = [b.encode() for b in spec["bodies"]]
    n_clients = spec["clients"]
    out: list = [None] * len(bodies)
    start = threading.Barrier(n_clients)

    def worker(k: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", spec["port"],
                                          timeout=120)
        try:
            start.wait()
            for i in range(k, len(bodies), n_clients):
                t0 = time.perf_counter()
                status, body = http_request(conn, "POST", spec["path"],
                                            bodies[i])
                out[i] = (status, body.decode(), time.perf_counter() - t0)
        finally:
            conn.close()

    t0 = time.perf_counter()
    with ThreadPoolExecutor(n_clients) as ex:
        for fut in [ex.submit(worker, k) for k in range(n_clients)]:
            fut.result()
    wall = time.perf_counter() - t0
    with open(spec_path + ".out", "w") as f:
        json.dump({"results": out, "wall_s": wall}, f)


def run_loadgen(port: int, bodies: list) -> dict:
    """One pass of the load generator in a child process of this script;
    returns its FILE.out."""
    build = os.path.join(ROOT, "gatekeeper_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="loadgen-", dir=build) as d:
        path = os.path.join(d, "spec.json")
        with open(path, "w") as f:
            json.dump({"port": port, "path": WEBHOOK_PATH,
                       "clients": WEBHOOK_CLIENTS, "bodies": bodies}, f)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--loadgen", path],
            capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"the load generator exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        with open(path + ".out") as f:
            return json.load(f)


class IsolationLog:
    """Records the webhook's own fallbacks from its log: the per-review
    isolation of a failed batch (webhook.py's _evaluate_violations) and
    any admission error answered per the failure stance."""

    MESSAGES = ("batched evaluation failed; isolating per review",
                "admission error")

    def __init__(self):
        import logging

        self.seen: list = []
        outer = self

        class Handler(logging.Handler):
            def emit(self, record):
                if record.getMessage() in outer.MESSAGES:
                    outer.seen.append((record.getMessage(),
                                       getattr(record, "structured", {})))

        self.handler = Handler()
        self.logger = logging.getLogger("gatekeeper.webhook")
        self.logger.addHandler(self.handler)

    def close(self) -> None:
        self.logger.removeHandler(self.handler)


def admission_bodies(tag: str, objs: list, pairs: list) -> tuple:
    """(uids, bodies, wanted response bodies): each object as an
    admission.k8s.io/v1 CREATE AdmissionReview with a unique uid, and
    the envelope of the verdict (verdict_response) of its interpreter
    (enforcement action, message) pairs, as the webhook encodes it."""
    from gatekeeper_tpu_torch.control.webhook import (encode_envelope,
                                                      verdict_response)

    uids = [f"{tag}-{i}" for i in range(len(objs))]
    bodies, want = [], []
    for uid, obj, prs in zip(uids, objs, pairs):
        group, _, version = obj["apiVersion"].rpartition("/")
        meta = obj["metadata"]
        bodies.append(json.dumps({
            "apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview",
            "request": {"uid": uid, "operation": "CREATE",
                        "kind": {"group": group, "version": version,
                                 "kind": obj["kind"]},
                        "name": meta.get("name"),
                        "namespace": meta.get("namespace"),
                        "userInfo": {"username": "chip-smoke"},
                        "object": obj}}))
        resp = verdict_response(prs)
        resp["uid"] = uid
        want.append(encode_envelope({
            "apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview", "response": resp}).decode())
    return uids, bodies, want


def percentile(xs: list, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def phase_webhook(dev, report: dict, served, small, smi_line: str) -> None:
    """Phase 9b: the 512 dense manifests of phase 9 as admission.k8s.io/v1
    CREATE AdmissionReviews through the port's WebhookServer on phase 9's
    driver (23 templates, the corpus as inventory), in three passes: as
    the cost model decides, then pinned to the card (batches of any
    size) cold, with async warm on, and warm, with it off. Every response
    must equal verdict_response of phase 9's interpreter results byte
    for byte; pinned, K2 launches on the serving threads (cold: at the
    shapes the warm thread has compiled); warm, no compiled kind is
    served by the interpreter. Then one what-if preview per PREVIEWS
    candidate at the general library's 10,000 objects, whose own
    violations must equal the interpreter's."""
    from gatekeeper_tpu_torch.control.preview import PreviewEngine
    from gatekeeper_tpu_torch.control.webhook import (
        MicroBatcher, ValidationHandler, WebhookServer)
    from gatekeeper_tpu_torch.kernels import build as kernel_build
    from gatekeeper_tpu_torch.kernels import clause as clause_mod
    from gatekeeper_tpu_torch.kernels.clause import clause_words
    from gatekeeper_tpu_torch.kernels.join_member import join_member
    from gatekeeper_tpu_torch.kernels.pair_compact import pair_compact

    drv, client, objs, pairs = served
    batcher = MicroBatcher(client)
    sizes: list = []
    evaluate = batcher._evaluate

    def sized(reviews):
        sizes.append(len(reviews))
        return evaluate(reviews)

    batcher._evaluate = sized
    handler = ValidationHandler(client, kube=None, batcher=batcher,
                                decision_cache_size=0)
    server = WebhookServer(handler, None, port=0, addr="127.0.0.1")
    server.start()
    isolation = IsolationLog()
    recs = {}
    # K2's launches on the serving threads, apart from the driver's warm
    # threads (named warm-<kind>), whose launches compile the cold shapes
    serving = {"K2": 0}
    lock = threading.Lock()
    count_launch = clause_mod.count_launch

    def counted(wrapper):
        count_launch(wrapper)
        if not threading.current_thread().name.startswith("warm-"):
            with lock:
                serving["K2"] += 1

    clause_mod.count_launch = counted
    try:
        for p, mode in enumerate(WEBHOOK_PASSES):
            if mode.startswith("pinned"):
                # every batch on the card: the device latency EMA would
                # otherwise move off phase 9's pin after the first sample,
                # and batches under MIN_DEVICE_BATCH never dispatch
                drv._use_device_for_batch = lambda n: True
                drv.MIN_DEVICE_BATCH = 1
            # the cold pass runs with async warm on, the package default:
            # a cold batch shape serves from the host while K2 compiles
            # off the request path. Compiling inline, a third to a half
            # of the cold pass's requests waited past the API server's
            # deadline (10 s, and 30 s) and were answered 504 per the
            # failure stance (PERF.md §6)
            drv.async_warm = mode == "pinned, cold"
            uids, bodies, want = admission_bodies(f"pass{p}", objs, pairs)
            if mode == "pinned, warm":
                drv.duty_cycle()  # the warm pass's window starts here
            counts0 = drv.eval_counts()
            k0 = {"K1": pair_compact.launches, "K2": clause_words.launches,
                  "K4": join_member.launches}
            c0, n_sizes = kernel_build.compiles, len(sizes)
            s0 = serving["K2"]
            out = run_loadgen(server.port, bodies)
            served_k2 = serving["K2"] - s0
            bad = [(u, r, w) for u, r, w in zip(uids, out["results"], want)
                   if r[0] != 200 or r[1] != w]
            check(not bad, f"webhook pass '{mode}': {len(bad)} of "
                  f"{len(bodies)} responses differ from the interpreter; "
                  f"first {bad[0][0]}: got {bad[0][1]!r:.600} want "
                  f"{bad[0][2]!r:.600}" if bad else "")
            check(not isolation.seen, f"webhook pass '{mode}': the webhook "
                  f"fell back: {isolation.seen[:3]}")
            lat = [r[2] for r in out["results"]]
            paths = kind_paths(drv, counts0)
            if mode == "pinned, cold":
                # K2 specializes on the row count (1, a multiple of 16,
                # other), and every library constraint matches every
                # review, so a kind's rows are the batch's size. The
                # closed loop need not form a batch of each class, and
                # the warm pass, which compiles inline, would stall on
                # the one it missed: batches of 1, 3 and 16 manifests
                # warm them here (cold shapes serve from the host), and
                # the drain below waits for their compiles
                for n in WARM_ROW_CLASSES:
                    got = [[(r.enforcement_action, r.msg) for r in
                            resp.results()]
                           for resp in client.review_batch(objs[:n])]
                    check(got == pairs[:n], f"webhook: the batch of {n} "
                          "after the cold pass differs from the "
                          "interpreter")
            drain = wait_warm(drv) if drv.async_warm else 0.0
            launched = {k: w.launches - k0[k] for k, w in (
                ("K1", pair_compact), ("K2", clause_words),
                ("K4", join_member))}
            batch_sizes = sizes[n_sizes:]
            rec = {"p50_ms": percentile(lat, 0.50) * 1e3,
                   "p99_ms": percentile(lat, 0.99) * 1e3,
                   "max_ms": max(lat) * 1e3,
                   "rps": len(lat) / out["wall_s"], "wall_s": out["wall_s"],
                   "batches": len(batch_sizes),
                   "batch_min": min(batch_sizes),
                   "batch_median": percentile(batch_sizes, 0.5),
                   "batch_max": max(batch_sizes),
                   "compiles": kernel_build.compiles - c0,
                   "warm_drain_s": drain,
                   "launches": launched, "k2_serving": served_k2,
                   "kinds": {k: len(v) for k, v in paths.items()}}
            if mode == "pinned, warm":
                rec["duty_cycle"] = drv.duty_cycle()
                check(rec["duty_cycle"] > 0, "webhook: duty cycle 0 after "
                      "the warm pass")
            if mode.startswith("pinned"):
                # cold, the batches at shapes the warm thread has
                # compiled: a pass served wholly by the host fails here
                check(served_k2 > 0 and paths.get("device"),
                      f"webhook pass '{mode}': K2 never launched on the "
                      f"serving path ({served_k2} launches; kinds per "
                      f"path {paths})")
            if mode == "pinned, warm":
                on_host = sorted(set(paths.get("interp", []))
                                 & set(drv._programs))
                check(not on_host, f"webhook pass '{mode}': compiled kinds "
                      f"served by the interpreter: {on_host}")
            log(f"[webhook] {smi_line}: pass '{mode}': {len(lat)} "
                f"AdmissionReviews over HTTP equal the interpreter; "
                f"latency p50 {rec['p50_ms']:.3f} ms, p99 "
                f"{rec['p99_ms']:.3f} ms, max {rec['max_ms']:.3f} ms; "
                f"{rec['rps']:.1f} requests/s ({WEBHOOK_CLIENTS} clients); "
                f"{rec['batches']} batches of {rec['batch_min']}-"
                f"{rec['batch_max']} (median {rec['batch_median']}); "
                f"launches {launched} (K2 on the serving threads "
                f"{served_k2}); {rec['compiles']} kernel compiles"
                + (f" (the warm drained {drain:.1f} s after the pass)"
                   if drv.async_warm else "") + "; kinds per path "
                + "; ".join(f"{k} {len(v)}" for k, v in sorted(paths.items()))
                + (f"; duty cycle {rec['duty_cycle']:.3f}"
                   if "duty_cycle" in rec else ""))
            recs[mode] = rec
    finally:
        clause_mod.count_launch = count_launch
        isolation.close()
        server.stop(drain_timeout=5.0)
        drv.async_warm = False
        for attr in ("_use_device_for_batch", "MIN_DEVICE_BATCH"):
            drv.__dict__.pop(attr, None)
    dbg = drv.templates_debug()["templates"]
    states: dict = {}
    for kind, ent in dbg.items():
        states.setdefault(ent["state"], []).append(kind)
    check(len(dbg) == 23 and len(states.get("compiled", [])) == 21 and
          sorted(states.get("join", [])) == sorted(JOIN_KINDS),
          f"templates_debug: {({k: len(v) for k, v in states.items()})}")
    log(f"[webhook] templates_debug: {len(dbg)} templates, "
        f"{len(states['compiled'])} on K2 programs, joins "
        f"{sorted(states['join'])}; eval counts of "
        + "; ".join(f"{k} {dbg[k]['eval_counts']}"
                    for k in ("K8sRequiredLabels", JOIN_KINDS[0])))
    report["webhook"] = recs

    # the what-if previews, at phase 8's 10,000 objects
    gdrv, gclient = small
    gdrv._use_device_for_batch = lambda n: True  # as the JAX tests force it
    pv = PreviewEngine(gclient)
    previews = {}
    # the results of the preview's own audit_kind sweep (it reports their
    # count and samples): held to the interpreter with no second sweep
    swept: list = []
    audit_kind = gdrv.audit_kind

    def recorded(*a, **k):
        got = audit_kind(*a, **k)
        swept.append(got)
        return got

    gdrv.audit_kind = recorded
    try:
        for kind, params, want_path in PREVIEWS:
            payload = {"constraint": library_constraint(
                kind, f"preview-{kind.lower()}", params)}
            k0 = (clause_words.launches, pair_compact.launches,
                  join_member.launches)
            t0 = time.perf_counter()
            n_swept = len(swept)
            out = pv.preview(payload)
            el = time.perf_counter() - t0
            k = (clause_words.launches - k0[0], pair_compact.launches -
                 k0[1], join_member.launches - k0[2])
            check(len(swept) == n_swept + 1, f"preview of {kind}: "
                  f"{len(swept) - n_swept} audit_kind sweeps, want 1")
            got, path = swept[-1]
            ent, cold = pv._ensure_template(None, kind)
            check(not cold, f"preview of {kind}: the alias was evicted")
            alias_con = dict(payload["constraint"], kind=ent["alias"])
            oracle = pv._interp_eval(ent["alias"], [alias_con])
            check(out["path"] == want_path and path == want_path,
                  f"preview of {kind} took {out['path']}, want {want_path}")
            check(out["violations"] == len(got) == len(oracle) and
                  sorted(result_key(got), key=repr) ==
                  sorted(result_key(oracle), key=repr) and
                  out["samples"] == pv._samples(got, "deny",
                                                len(out["samples"])),
                  f"preview of {kind}: {out['violations']} violations, "
                  f"the interpreter {len(oracle)}")
            if want_path == "device":
                check(k[0] > 0, f"preview of {kind}: K2 never launched")
            log(f"[webhook] {smi_line}: preview of a {kind} candidate over "
                f"{out['reviewed']} objects: {out['violations']} violations "
                f"(the interpreter {len(oracle)}), path {out['path']}, "
                f"{el:.3f} s cold; launches K2 {k[0]}, K1 {k[1]}, K4 {k[2]}")
            previews[kind] = {"s": el, "violations": out["violations"],
                              "path": out["path"], "k2": k[0], "k1": k[1],
                              "k4": k[2]}
    finally:
        gdrv.__dict__.pop("_use_device_for_batch", None)
        gdrv.__dict__.pop("audit_kind", None)
    report["previews"] = previews


# phase 9c: the reconcile controllers (control/controllers.py) over a
# FakeKube, as main.Runtime wires them: a GuardedKube with the shared
# write breaker, Runtime's built-in kinds, and the corpus kinds synced
CONTROLLER_KINDS = (
    (("", "v1", "Namespace"), False), (("", "v1", "Pod"), True),
    (("", "v1", "Service"), True), (("", "v1", "Secret"), True),
    (("apps", "v1", "Deployment"), True),
    (("networking.k8s.io", "v1beta1", "Ingress"), True),
    (("templates.gatekeeper.sh", "v1beta1", "ConstraintTemplate"), False),
    (("config.gatekeeper.sh", "v1alpha1", "Config"), True),
    (("apiextensions.k8s.io", "v1beta1", "CustomResourceDefinition"),
     False))
CONTROLLER_SYNC = (("", "v1", "Pod"), ("", "v1", "Service"),
                   ("apps", "v1", "Deployment"),
                   ("networking.k8s.io", "v1beta1", "Ingress"))
# the edit made through the kube: one constraint's parameters, one
# template deleted
CONTROLLER_EDIT = ("K8sContainerLimits", "limits-capped",
                   {"cpu": "500m", "memory": "256Mi"})
CONTROLLER_DELETE = "general/httpsonly"
DEMO_TIMEOUT_S = 180


def controller_plane(driver):
    """(FakeKube, Client on `driver`, started ControllerManager) with
    phase 9's library (23 templates, their constraints) written to the
    kube as objects and a Config syncing the 2,000-object corpus, which
    the sync controller loads as inventory. Returns after the
    controllers drained."""
    from gatekeeper_tpu_torch import policies
    from gatekeeper_tpu_torch.client import Backend
    from gatekeeper_tpu_torch.control import ControllerManager, FakeKube
    from gatekeeper_tpu_torch.control.resilience import (
        CircuitBreaker, GuardedKube, RetryBudget)
    from gatekeeper_tpu_torch.parallel.workload import (
        GENERAL_CONSTRAINTS, PSP_CONSTRAINTS)
    from gatekeeper_tpu_torch.target import K8sValidationTarget

    kube = FakeKube()
    for gvk, namespaced in CONTROLLER_KINDS:
        kube.register_kind(gvk, namespaced=namespaced)
    client = Backend(driver).new_client([K8sValidationTarget()])
    mgr = ControllerManager(GuardedKube(kube, CircuitBreaker("kube-writes"),
                                        RetryBudget(10.0)), client)
    mgr.start()
    for name in policies.names():
        kube.create(policies.load(name))
    mgr.drain(120)
    for kind, cname, params in GENERAL_CONSTRAINTS + PSP_CONSTRAINTS:
        kube.create(library_constraint(kind, cname, params))
    kube.create({
        "apiVersion": "config.gatekeeper.sh/v1alpha1", "kind": "Config",
        "metadata": {"name": "config", "namespace": "gatekeeper-system"},
        "spec": {"sync": {"syncOnly": [
            {"group": g, "version": v, "kind": k}
            for g, v, k in CONTROLLER_SYNC]}}})
    mgr.drain(120)
    for o in corpus(2000):  # a later copy of a name replaces the earlier
        kube.apply(o)
    mgr.drain(120)
    return kube, client, mgr


def controller_edit(kube, mgr) -> None:
    from gatekeeper_tpu_torch import policies

    kind, cname, params = CONTROLLER_EDIT
    c = kube.get(("constraints.gatekeeper.sh", "v1beta1", kind), cname)
    c["spec"]["parameters"] = params
    kube.update(c)
    kube.delete(("templates.gatekeeper.sh", "v1beta1", "ConstraintTemplate"),
                policies.load(CONTROLLER_DELETE)["metadata"]["name"])
    mgr.drain(120)


def library_objects(kube) -> dict:
    """The templates and constraints in the kube: (kind, name) -> (its
    resourceVersion, its status)."""
    out = {}
    for o in kube.list(("templates.gatekeeper.sh", "v1beta1",
                        "ConstraintTemplate")):
        out[("ConstraintTemplate", o["metadata"]["name"])] = (
            o["metadata"]["resourceVersion"], o.get("status"))
        kind = o["spec"]["crd"]["spec"]["names"]["kind"]
        for c in kube.list(("constraints.gatekeeper.sh", "v1beta1", kind)):
            out[(kind, c["metadata"]["name"])] = (
                c["metadata"]["resourceVersion"], c.get("status"))
    return out


def top_device_ops(prof, n: int = 5) -> list:
    """The n operations with the most device time in a torch.profiler
    run: (name, calls, device ms)."""
    rows = []
    for a in prof.key_averages():
        us = getattr(a, "self_device_time_total",
                     getattr(a, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((a.key, a.count, us / 1e3))
    return sorted(rows, key=lambda r: -r[2])[:n]


def phase_controllers(dev, report: dict, served, smi_line: str):
    """Phase 9c: phase 9's library and corpus written to a FakeKube and
    reconciled by a ControllerManager onto a fresh foreground driver (the
    card). Phase 9's 512 dense manifests, reviewed as the cost model
    decides and pinned to the card, must equal phase 9's interpreter
    pairs; pinned, K2 launches on the serving thread (this one), and no
    K2 launch runs on a controller's worker thread. Then, through the
    kube, one constraint's parameters change and one template is
    deleted: the pinned review, run inside device_trace, must equal a
    RegoDriver client reconciled by its own ControllerManager from the
    same kube operations, the two kubes' template and constraint statuses
    must be equal, and the status writes must reach a fixpoint. The
    trace must name K2's kernel. The demo (policies/demo.py) runs beside
    it as a child on the card and must print ALLOWED and DENIED. Returns
    the two planes, their controllers still running, for phase 9d
    (`Planes`), which stops them."""
    from gatekeeper_tpu_torch.client import RegoDriver
    from gatekeeper_tpu_torch.kernels import clause as clause_mod
    from gatekeeper_tpu_torch.kernels.clause import clause_words
    from gatekeeper_tpu_torch.utils import profiling

    # the demo on the card, beside the phase; its output is a few lines
    t_demo = time.perf_counter()
    demo = subprocess.Popen(
        [sys.executable, "-m", "gatekeeper_tpu_torch.policies.demo"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    trace_dir = tempfile.mkdtemp(prefix="trace-", dir=os.path.join(
        ROOT, "gatekeeper_tpu_torch", "_build"))
    _drv9, _client9, objs, pairs = served
    # K2's launches by thread name
    threads: dict = {}
    lock = threading.Lock()
    count_launch = clause_mod.count_launch

    def counted(wrapper):
        count_launch(wrapper)
        if wrapper is clause_words:
            name = threading.current_thread().name
            with lock:
                threads[name] = threads.get(name, 0) + 1

    def review(client) -> list:
        return [[(r.enforcement_action, r.msg) for r in resp.results()]
                for resp in client.review_batch(objs)]

    clause_mod.count_launch = counted
    planes = []
    handed = None
    try:
        t0 = time.perf_counter()
        drv = foreground_driver()
        kube, client, mgr = controller_plane(drv)
        planes.append(mgr)
        ingest_s = time.perf_counter() - t0
        check(len(drv.compiled_kinds()) == 23 and
              drv.fallback_reasons() == {},
              f"controllers: {len(drv.compiled_kinds())} device kinds")
        t0 = time.perf_counter()
        okube, oracle, omgr = controller_plane(RegoDriver())
        planes.append(omgr)
        oracle_s = time.perf_counter() - t0
        rec = {"ingest_s": ingest_s, "oracle_ingest_s": oracle_s}
        me = threading.current_thread().name
        for mode in ("cost model", "pinned"):
            if mode == "pinned":
                drv._use_device_for_batch = lambda n: True
            counts0 = drv.eval_counts()
            k0 = threads.get(me, 0)
            t0 = time.perf_counter()
            got = review(client)
            el = time.perf_counter() - t0
            check(got == pairs, f"controllers: the 512 batch ({mode}) "
                  "differs from phase 9's interpreter")
            paths = kind_paths(drv, counts0)
            rec[mode] = {"s": el, "k2_serving": threads.get(me, 0) - k0,
                         "kinds": {k: len(v) for k, v in paths.items()}}
            if mode == "pinned":
                check(rec[mode]["k2_serving"] > 0,
                      "controllers: K2 never launched on the serving thread")
                check(not paths.get("interp"), f"controllers, pinned: kinds "
                      f"served by the interpreter: {paths.get('interp')}")
            log(f"[controllers] {smi_line}: 512 manifests ({mode}) equal "
                f"phase 9's interpreter: {el:.3f} s, K2 launches on the "
                f"serving thread {rec[mode]['k2_serving']}; kinds per path "
                + "; ".join(f"{p} {len(k)}" for p, k in paths.items()))
        t0 = time.perf_counter()
        controller_edit(kube, mgr)
        controller_edit(okube, omgr)
        rec["edit_s"] = time.perf_counter() - t0
        check(not client.knows_kind("K8sHttpsOnly") and
              not oracle.knows_kind("K8sHttpsOnly"),
              "controllers: the deleted template's kind is still known")
        want = [result_key(r.results()) for r in oracle.review_batch(objs)]
        k0 = threads.get(me, 0)
        t0 = time.perf_counter()
        with profiling.device_trace(trace_dir) as prof:
            got = [result_key(r.results()) for r in client.review_batch(objs)]
        rec["traced_s"] = time.perf_counter() - t0
        check(got == want, "controllers: after the edit the 512 batch "
              "differs from the RegoDriver controllers'")
        check(threads.get(me, 0) > k0, "controllers: K2 never launched in "
              "the traced batch")
        files = [f for f in os.listdir(trace_dir)
                 if f.endswith(".pt.trace.json")]
        check(len(files) == 1, f"controllers: trace files {files}")
        with open(os.path.join(trace_dir, files[0]), "rb") as f:
            trace = f.read()
        check(b"clause_kernel" in trace, "controllers: the trace does not "
              "name clause_kernel")
        top = top_device_ops(prof)
        log(f"[controllers] {smi_line}: the traced batch after the edit "
            f"({sum(len(k) for k in got)} results equal the RegoDriver "
            f"controllers'), {rec['traced_s']:.3f} s; trace "
            f"{len(trace)} bytes; top device operations: "
            + "; ".join(f"{k} x{c} {ms:.3f} ms" for k, c, ms in top))
        rec["top_device_ops"] = top
        objs_t, objs_o = library_objects(kube), library_objects(okube)
        check({k: v[1] for k, v in objs_t.items()} ==
              {k: v[1] for k, v in objs_o.items()},
              "controllers: template and constraint statuses differ from "
              "the RegoDriver controllers'")
        time.sleep(0.5)  # idle: no event may cause another write
        mgr.drain(120)
        check(library_objects(kube) == objs_t,
              "controllers: status writes keep coming (no fixpoint)")
        rec["objects"] = len(objs_t)
        stray = {n: c for n, c in threads.items() if n.startswith("ctrl-")}
        check(not stray, f"controllers: K2 launched on worker threads "
              f"{stray}")
        try:
            out, err = demo.communicate(timeout=max(
                1.0, DEMO_TIMEOUT_S - (time.perf_counter() - t_demo)))
        except subprocess.TimeoutExpired:
            raise Fail(f"the demo ran past {DEMO_TIMEOUT_S} s")
        demo_s = time.perf_counter() - t_demo
        check(demo.returncode == 0 and "ALLOWED" in out and "DENIED" in out,
              f"the demo exited {demo.returncode}: {out[-800:]} "
              f"{err[-1500:]}")
        rec["demo_s"] = demo_s
        log(f"[controllers] {smi_line}: ingest through the controllers "
            f"{ingest_s:.1f} s ({len(objs_t)} templates and constraints, "
            f"statuses equal the RegoDriver controllers' and at a "
            f"fixpoint), the edit {rec['edit_s']:.1f} s; the demo on the "
            f"card {demo_s:.1f} s: "
            + " | ".join(line.strip() for line in out.splitlines()
                         if "ALLOWED" in line or "DENIED" in line))
        handed = Planes(card=(kube, client, drv), oracle=(okube, oracle),
                        managers=planes)
    finally:
        clause_mod.count_launch = count_launch
        if handed is None:
            for m in planes:
                m.stop()
        if demo.poll() is None:
            demo.kill()
            demo.communicate()
        shutil.rmtree(trace_dir, ignore_errors=True)
    report["controllers"] = rec
    return handed


# phase 9c's two planes, handed to phase 9d: (kube, client, driver) on
# the card, (kube, client) on the interpreter, and their controllers
Planes = types.SimpleNamespace

# phase 9d (b): BENCH config 11's streaming audit at config 6's pods. The
# counts are the JAX package's (tests/torch_reference_counts.py
# --stream 50000): the first sweep, and the full resync after the
# STREAM_ROUNDS churn rounds
STREAM_PODS = 50_000
STREAM_RESULTS = 58902
STREAM_RESYNC_RESULTS = 59136
STREAM_WINDOW_S = 0.025
STATUS_LIMIT = 20  # control/audit.py DEFAULT_CONSTRAINT_VIOLATIONS_LIMIT


def per_constraint(results, capped: bool = False) -> dict:
    """An audit's results per constraint, in order: message, resource
    (kind, namespace, name) and action. `capped`: the messages past each
    constraint's first STATUS_LIMIT left out (a capped sweep keeps them
    count-only where the driver's vectorized messages would assemble
    them, and the statuses publish the first STATUS_LIMIT)."""
    out: dict = {}
    for r in results:
        c = r.constraint or {}
        res = r.resource or {}
        meta = res.get("metadata") or {}
        run = out.setdefault((c.get("kind"), (c.get("metadata") or {}).get(
            "name")), [])
        msg = None if capped and len(run) >= STATUS_LIMIT else r.msg
        run.append((msg, res.get("kind"), meta.get("namespace"),
                    meta.get("name"), r.enforcement_action))
    return out


def constraint_statuses(kube, kinds) -> dict:
    """(kind, name) -> the constraint's status, its auditTimestamp (a
    clock) left out."""
    out = {}
    for kind in kinds:
        for o in kube.list(("constraints.gatekeeper.sh", "v1beta1", kind)):
            st = dict(o.get("status") or {})
            st.pop("auditTimestamp", None)
            out[(kind, o["metadata"]["name"])] = st
    return out


def kernel_wrappers() -> dict:
    """K1-K6's wrappers, each counting its kernel's launches."""
    from gatekeeper_tpu_torch.kernels.clause import clause_words
    from gatekeeper_tpu_torch.kernels.join_member import join_member
    from gatekeeper_tpu_torch.kernels.pair_compact import pair_compact
    from gatekeeper_tpu_torch.kernels.regex_scan import regex_scan
    from gatekeeper_tpu_torch.kernels.rows_update import rows_update
    from gatekeeper_tpu_torch.kernels.shard_counts import shard_counts

    return {"K1": pair_compact, "K2": clause_words, "K3": regex_scan,
            "K4": join_member, "K5": rows_update, "K6": shard_counts}


def launch_counts() -> dict:
    return {k: w.launches for k, w in kernel_wrappers().items()}


def launched(before: dict) -> dict:
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


def manager_sweeps(planes, smi_line: str) -> dict:
    """Phase 9d (a): on each of phase 9c's kubes an AuditManager sweep in
    the default mode (discovery: list every auditable kind, then
    review_batch) and then from the cache (client.audit() over the synced
    inventory, the violations cap armed). The card plane's results equal
    the interpreter plane's per constraint (message, resource, action,
    in order), the statuses the two managers wrote are equal
    (totalViolations and at most STATUS_LIMIT entries), and K2 launches
    on the card plane's sweeps."""
    from gatekeeper_tpu_torch.control import AuditManager

    kube, client, drv = planes.card
    okube, oracle = planes.oracle
    # phase 9c left the card plane pinned to the device: every kind of a
    # sweep dispatches, whatever its size
    drv._use_device_for_batch = lambda n: True
    kinds = sorted(client.template_kinds())
    check(len(kinds) == 22 and kinds == sorted(oracle.template_kinds()),
          f"audit manager: phase 9c's planes hold {len(kinds)} kinds")
    # the Namespaces of the corpus and of the Config, as a cluster holds
    # them: the discovery sweep sideloads each namespaced object's
    # Namespace, and skips an object whose Namespace the kube lacks
    names = sorted({o["metadata"].get("namespace") for o in corpus(2000)}
                   - {None, ""} | {"gatekeeper-system"})
    for k in (kube, okube):
        for name in names:
            k.apply({"apiVersion": "v1", "kind": "Namespace",
                     "metadata": {"name": name}})
    for m in planes.managers:
        m.drain(120)
    rec = {"namespaces": len(names)}
    for mode, kw in (("default", {}),
                     ("from cache", {"audit_from_cache": True})):
        before = launch_counts()
        t0 = time.perf_counter()
        mgr = AuditManager(kube, client, **kw)
        got = mgr.audit_once()
        el = time.perf_counter() - t0
        k = launched(before)
        mgr.stop()
        t0 = time.perf_counter()
        omgr = AuditManager(okube, oracle, **kw)
        want = omgr.audit_once()
        oracle_s = time.perf_counter() - t0
        omgr.stop()
        mine, theirs = per_constraint(got), per_constraint(want)
        count_only = sum(1 for run in mine.values()
                         for e in run[STATUS_LIMIT:] if not e[0])
        check(per_constraint(got, True) == per_constraint(want, True) and
              all(e[0] in ("", f[0]) for key, run in mine.items()
                  for e, f in zip(run, theirs[key])),
              f"audit manager ({mode}): the card plane's results differ "
              "from the interpreter plane's")
        st, ost = constraint_statuses(kube, kinds), \
            constraint_statuses(okube, kinds)
        check(st == ost, f"audit manager ({mode}): the statuses written "
              "differ from the interpreter plane's")
        check(sum(v.get("totalViolations", 0) for v in st.values())
              == len(got) and all(len(v.get("violations") or [])
                                  <= STATUS_LIMIT for v in st.values()),
              f"audit manager ({mode}): statuses do not carry the totals "
              "or exceed the cap")
        check(k["K2"] > 0, f"audit manager ({mode}): K2 never launched")
        path = (drv.last_audit_path if kw else drv.last_review_batch_path)
        rec[mode] = {"s": el, "oracle_s": oracle_s, "results": len(got),
                     "count_only": count_only, "constraints": len(st),
                     "launches": k, "path": path}
        log(f"[audit manager] {smi_line}: {mode} sweep over phase 9c's "
            f"kube, {len(got)} results in {el:.3f} s (interpreter plane "
            f"{oracle_s:.3f} s), equal per constraint ({count_only} "
            f"count-only past the cap of {STATUS_LIMIT}), {len(st)} "
            f"statuses equal; path {path}; launches {k}")
    return rec


def manager_stream(smi_line: str) -> dict:
    """Phase 9d (b): BENCH config 11's streaming audit (part 1) at config
    6's 50,000 pods, on a FakeKube and a fresh foreground driver: the
    first incremental sweep (tracker built, inventory encoded, K2 and K1
    per slab) gives STREAM_RESULTS results and statuses summing to it,
    its trace phases printed from the flight recorder; the second is
    delta-served and writes no status; the stream loop then serves
    STREAM_ROUNDS churn rounds (flush latencies, 0 errors); a full-resync
    sweep of the same manager re-lists and re-encodes, gives
    STREAM_RESYNC_RESULTS (the JAX package's count), its results equal
    the stream's last flush per constraint (the resources and actions in
    order, and the messages the statuses carry) and it rewrites no
    status entry the stream published; the totals it repairs (a flush
    misses a total that moved past the cap, as in the JAX package) are
    printed. No status writer thread enters a kernel lock."""
    import random

    from gatekeeper_tpu_torch.control import AuditManager
    from gatekeeper_tpu_torch.control import trace as gtrace
    from gatekeeper_tpu_torch.control.kube import FakeKube
    from gatekeeper_tpu_torch.kernels import build
    from gatekeeper_tpu_torch.parallel.workload import (
        PSP_CONSTRAINTS, STREAM_ROUND_GAP_S, STREAM_ROUNDS,
        stream_churn_pods, synth_pods_psp)

    kinds = sorted({k for k, _n, _p in PSP_CONSTRAINTS})
    status_writes = lambda: sum(  # noqa: E731
        1 for c in kube.calls if c[0] == "update" and c[3] == "status")
    rec: dict = {}
    t0 = time.perf_counter()
    kube = FakeKube()
    kube.register_kind(("", "v1", "Namespace"), namespaced=False)
    kube.register_kind(("", "v1", "Pod"), namespaced=True)
    pods = synth_pods_psp(STREAM_PODS)
    for i, pod in enumerate(pods):
        pod["metadata"]["uid"] = f"c11-{i}"
        kube.create(pod)
    drv = foreground_driver()
    client = psp_client(drv, ())
    for c in PSP_CONSTRAINTS:
        kube.apply(library_constraint(*c))
    mgr = AuditManager(kube, client, incremental=True, interval=3600,
                       stream_audit=True, stream_window_s=STREAM_WINDOW_S)
    rec["setup_s"] = time.perf_counter() - t0
    settle()
    # the threads that enter a kernel lock during the phase
    lockers: set = set()
    real_held = build.held

    def held(lock):
        lockers.add(threading.current_thread().name)
        return real_held(lock)

    build.held = held
    try:
        gtrace.TRACER.recorder.clear()
        before = launch_counts()
        t0 = time.perf_counter()
        first = mgr.audit_once()
        first_s = time.perf_counter() - t0
        rec["first"] = {"s": first_s, "launches": launched(before),
                        "path": drv.last_audit_path}
        st = constraint_statuses(kube, kinds)
        total = sum(v.get("totalViolations", 0) for v in st.values())
        check(len(first) == STREAM_RESULTS and total == STREAM_RESULTS,
              f"audit manager, streaming: first sweep {len(first)} "
              f"results, statuses sum {total}, want {STREAM_RESULTS}")
        check(rec["first"]["launches"]["K1"] > 0 and
              rec["first"]["launches"]["K2"] > 0,
              f"audit manager, streaming: the first sweep launched "
              f"{rec['first']['launches']}")
        (trace,) = audit_traces()
        rec["first"]["trace"] = sweep_trace(trace)
        log(f"[audit manager] {smi_line}: streaming manager, first sweep "
            f"({trace['status']}) {len(first)} results, statuses sum "
            f"{total}, {first_s:.3f} s; its trace phases: "
            + ", ".join(f"{k} {v:.3f} s"
                        for k, v in rec["first"]["trace"]["spans"].items())
            + f" (trace {trace['duration_s']:.3f} s); launches "
            f"{rec['first']['launches']}")
        n0 = status_writes()
        before = launch_counts()
        t0 = time.perf_counter()
        second = mgr.audit_once()
        rec["second"] = {"s": time.perf_counter() - t0,
                         "path": drv.last_audit_path,
                         "launches": launched(before),
                         "status_writes": status_writes() - n0}
        check(len(second) == STREAM_RESULTS and
              mgr.last_sweep_stats.get("sweep") == "incremental" and
              drv.last_audit_path.startswith("delta(") and
              rec["second"]["status_writes"] == 0,
              f"audit manager, streaming: second sweep {len(second)} "
              f"results, {rec['second']}")
        # the stream loop: armed by start(), beside the interval loop's
        # own first sweep (incremental, nothing dirty)
        lat: list = []
        lat_lock = threading.Lock()

        def on_flush(samples, writes):
            with lat_lock:
                lat.extend(samples)

        mgr.on_flush = on_flush
        mgr.start()
        t_wait = time.perf_counter()
        while not (mgr.tracker.track_event_times and mgr._sweeps >= 3):
            check(time.perf_counter() - t_wait < 120, "audit manager, "
                  "streaming: the stream loop never armed")
            time.sleep(0.01)
        with mgr._sweep_lock:  # the interval loop's sweep has evaluated
            pass
        before = launch_counts()
        rng = random.Random(11)
        burst = max(1, STREAM_PODS // 100 // STREAM_ROUNDS)
        t0 = time.perf_counter()
        for r in range(STREAM_ROUNDS):
            for pod in stream_churn_pods(pods, rng, r, burst):
                kube.apply(pod)
            time.sleep(STREAM_ROUND_GAP_S)
        churn_s = time.perf_counter() - t0
        while mgr.tracker.pending_count() or \
                not mgr._sweep_lock.acquire(blocking=False):
            check(time.perf_counter() - t0 < 180, "audit manager, "
                  "streaming: events still pending after 180 s")
            time.sleep(0.01)
        mgr._sweep_lock.release()
        mgr.stop()
        drain_s = time.perf_counter() - t0 - churn_s
        stats = dict(mgr.stream_stats)
        with lat_lock:
            samples = sorted(lat)
        check(mgr.tracker.pending_count() == 0 and stats["errors"] == 0
              and stats["flushes"] > 0 and stats["events"] == len(samples)
              and samples, f"audit manager, streaming: {stats}, "
              f"{len(samples)} latencies")
        rec["stream"] = {
            **stats, "rounds": STREAM_ROUNDS, "burst": burst,
            "churn_s": churn_s, "drain_s": drain_s,
            "p50_ms": 1e3 * percentile(samples, 0.50),
            "p99_ms": 1e3 * percentile(samples, 0.99),
            "max_ms": 1e3 * samples[-1], "launches": launched(before)}
        log(f"[audit manager] {smi_line}: streaming, {STREAM_ROUNDS} "
            f"rounds of {burst} pod replacements {STREAM_ROUND_GAP_S} s "
            f"apart: {stats['flushes']} flushes, {stats['events']} "
            f"events, {stats['errors']} errors, {stats['skipped']} "
            f"skipped; detection latency p50 {rec['stream']['p50_ms']:.1f}"
            f" ms, p99 {rec['stream']['p99_ms']:.1f} ms, max "
            f"{rec['stream']['max_ms']:.1f} ms; the last flush "
            f"{drain_s:.3f} s after the last round; launches "
            f"{rec['stream']['launches']}")
        # the full resync (re-list, re-encode) against what the stream
        # published; past each constraint's cap a result is count-only,
        # or carries its message when a flush re-evaluated its row on
        # the host (as in the JAX package), so results compare capped
        streamed = per_constraint(mgr.last_results, capped=True)
        published = constraint_statuses(kube, kinds)
        mgr.full_resync_every = 1  # the next sweep is the periodic one
        before = launch_counts()
        t0 = time.perf_counter()
        resync = mgr.audit_once()
        rec["resync"] = {"s": time.perf_counter() - t0,
                         "sweep": mgr.last_sweep_stats.get("sweep"),
                         "results": len(resync),
                         "launches": launched(before)}
        check(rec["resync"]["sweep"] == "full_resync" and
              len(resync) == STREAM_RESYNC_RESULTS,
              f"audit manager, streaming: the resync sweep "
              f"{rec['resync']}, want {STREAM_RESYNC_RESULTS} results")
        fresh = per_constraint(resync, capped=True)
        rewritten = constraint_statuses(kube, kinds)
        drift = sorted(f"{k[0]}/{k[1]}" for k in set(fresh) | set(streamed)
                       if fresh.get(k) != streamed.get(k))
        check(not drift, f"audit manager, streaming: the full resync's "
              f"results differ from the stream's last flush: {drift}")
        # a flush lists and writes only the kinds whose capped status
        # entries moved (the JAX package's _stream_flush fingerprints
        # the entries, not totalViolations), so a violation added or
        # removed past a constraint's first STATUS_LIMIT leaves its
        # published total stale until an interval sweep: the resync may
        # repair totals, never entries
        repaired = {f"{k[0]}/{k[1]}": [published.get(k, {}).get(
            "totalViolations"), st.get("totalViolations")]
            for k, st in rewritten.items() if st != published.get(k)}
        check(all(st.get("violations") == published.get(k, {}).get(
                  "violations") for k, st in rewritten.items()),
              "audit manager, streaming: the full resync rewrote status "
              "entries the stream published")
        check(sum(st.get("totalViolations", 0) for st in rewritten.values())
              == STREAM_RESYNC_RESULTS, "audit manager, streaming: the "
              "resync's statuses do not sum to its results")
        rec["resync"]["total_repairs"] = repaired
        check(rec["resync"]["launches"]["K1"] > 0 and
              rec["resync"]["launches"]["K2"] > 0,
              f"audit manager, streaming: the resync launched "
              f"{rec['resync']['launches']}")
        stray = sorted(t for t in lockers
                       if t.startswith("audit-status-stream"))
        check(not stray, f"audit manager: a status writer entered a "
              f"kernel lock: {stray}")
        log(f"[audit manager] {smi_line}: full resync {len(resync)} "
            f"results (the JAX package's {STREAM_RESYNC_RESULTS}) in "
            f"{rec['resync']['s']:.3f} s, equal to the stream's last "
            f"flush per constraint, status entries unchanged; totals it "
            f"repaired (published, resync): {repaired or 'none'}; "
            f"launches {rec['resync']['launches']}; threads in a kernel "
            f"lock: {sorted(lockers)}")
    finally:
        build.held = real_held
        mgr.stop()
    return rec


def phase_audit_manager(dev, report: dict, planes, smi_line: str) -> None:
    """Phase 9d (a): the audit manager (control/audit.py) on the card in
    the JAX package's default and from-cache modes, on phase 9c's planes
    (manager_sweeps). Stops phase 9c's controllers. Part (b), the
    streaming audit, runs in the lifecycle child (phase_audit_stream)."""
    try:
        report["audit_manager"] = manager_sweeps(planes, smi_line)
    finally:
        for m in planes.managers:
            m.stop()


def phase_audit_stream(dev, report: dict, smi_line: str) -> None:
    """Phase 9d (b), in the lifecycle child after phases 15 and 16: the
    streaming audit at config 6's pods (manager_stream), with the launch
    counts of its own run (zeroed just before it, read just after), which
    the smoke adds to phase 9d's."""
    for w in kernel_wrappers().values():
        w.launches = 0
    rec = manager_stream(smi_line)
    rec["launches"] = launch_counts()
    report["audit_stream"] = rec


# phase 15 (d): the faulted kinds, one review-pure and one join
LIFECYCLE_BAD = ("K8sContainerLimits", "K8sUniqueIngressHost")


def forget_k2_modules() -> None:
    """Forget the generated K2 modules this process imported: the next
    launch of each loads a fresh JIT function with an empty in-memory
    cache, so that with a new TRITON_CACHE_DIR its compiles are real."""
    for name in [m for m in sys.modules if "._build_k2_" in m]:
        del sys.modules[name]


def wait_for(cond, timeout: float, what: str) -> float:
    """Wait until cond() holds, failing the phase with `what` after
    `timeout` s; returns the seconds waited."""
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < timeout, f"{what} in {timeout} s")
        time.sleep(0.02)
    return time.perf_counter() - t0


def wait_warm(drv, timeout: float = 600.0) -> float:
    """Wait for the driver's background warm to drain; returns the
    seconds waited."""
    return wait_for(lambda: not drv.warm_status()["compiling"], timeout,
                    "the warm did not drain")


def http_request(conn, method: str, path: str, body=None) -> tuple:
    """(status, body bytes) of one request on an open HTTPConnection."""
    conn.request(method, path, body,
                 {"Content-Type": "application/json"} if body else {})
    resp = conn.getresponse()
    return resp.status, resp.read()


def serving_compiles(before: dict) -> dict:
    """Per thread name, the kernel compiles since `before` (a
    kernels/build.compiles_by_thread()) on threads other than the
    driver's warm and prewarm threads (warm-<kind>, aot-prewarm-<kind>)."""
    from gatekeeper_tpu_torch.kernels import build as kernel_build

    return {t: n - before.get(t, 0)
            for t, n in kernel_build.compiles_by_thread().items()
            if n > before.get(t, 0)
            and not t.startswith(("warm-", "aot-prewarm-"))}


def kind_paths(drv, before: dict) -> dict:
    """path -> the kinds that evaluated through it since `before`."""
    out: dict = {}
    for (kind, path), c in drv.eval_counts().items():
        if c > before.get((kind, path), 0):
            out.setdefault(path, []).append(kind)
    return {p: sorted(k) for p, k in sorted(out.items())}


def warm_rounds(what: str, drv, run, want, rounds: int = 4) -> list:
    """Wait for the warm the cold call started to drain, then run `run()`
    (an audit or a batch) until a round starts no new warm (finds every
    shape it dispatches warm), at most `rounds` times, draining after
    each. Every round must return `want` and compile nothing on this
    thread. A round can find a shape cold that an earlier one warmed: a
    kind that ran early in a call saw a smaller vocabulary (its match
    table and derived columns are padded to the vocabulary's capacity,
    ops/strtab.vocab_cap) than the kinds after it interned. Returns the
    first drain's seconds and per round (seconds, paths, drain seconds,
    K2 launches)."""
    from gatekeeper_tpu_torch.kernels import build as kernel_build
    from gatekeeper_tpu_torch.kernels.clause import clause_words

    fg = kernel_build.thread_compiles()
    first_drain = wait_warm(drv)
    log(f"[lifecycle] {what}: the cold call's warm drained "
        f"{first_drain:.3f} s after it returned")
    out = []
    for r in range(rounds):
        # the delta cache would serve an unchanged re-audit unswept
        drv._audit_results_cache.clear()
        done0 = set(drv._warm_done)
        counts0 = drv.eval_counts()
        k2 = clause_words.launches
        t0 = time.perf_counter()
        got = run()
        el = time.perf_counter() - t0
        k2 = clause_words.launches - k2
        paths = kind_paths(drv, counts0)
        check(got == want, f"{what}, round {r + 1}: results differ")
        check(kernel_build.thread_compiles() == fg,
              f"{what}, round {r + 1}: a compile on the serving thread")
        check(not drv.quarantine_status() and not drv._quarantine_hist,
              f"{what}, round {r + 1}: quarantined "
              f"{drv.quarantine_status()}")
        drain = wait_warm(drv)
        cold = sorted({drv._sig_kind(sig) for sig in drv._warm_done - done0})
        log(f"[lifecycle] {what}, round {r + 1}: {el:.3f} s; per kind: "
            + "; ".join(f"{p} {ks}" for p, ks in paths.items())
            + f"; cold shapes warmed {cold}; drained {drain:.3f} s "
            f"later; K2 launches {k2}")
        out.append((el, paths, drain, k2))
        if not cold:
            return first_drain, out
    raise Fail(f"{what}: still cold shapes after {rounds} rounds")


def lifecycle_config6(rec: dict, aot_dir: str) -> None:
    """(a) config 6 at LIFECYCLE_PODS, async warm on: the first audit serves
    the cold kinds from the host while the warm compiles; after the
    drain, every compiled kind on the card with no foreground compile,
    and the foreground's latency sample in the EMA (warm_rounds). The
    driver's program store (`aot_dir`) keeps every K2 variant it
    compiled and every sweep signature it ran, for phase 16."""
    from gatekeeper_tpu_torch.ir import TorchDriver
    from gatekeeper_tpu_torch.parallel.workload import synth_pods_psp

    drv = TorchDriver(aot_dir=aot_dir)
    check(drv.async_warm, "async warm is not the package default")
    check(drv.aot.enabled, f"the program store at {aot_dir} is disabled")
    client = psp_client(drv, synth_pods_psp(LIFECYCLE_PODS))
    settle()

    def audit():
        return result_key(client.audit().results())

    t0 = time.perf_counter()
    want = audit()
    first = time.perf_counter() - t0
    check(len(want) == LIFECYCLE_RESULTS, f"config 6 first audit with "
          f"async warm: {len(want)} results, want {LIFECYCLE_RESULTS}")
    paths = kind_paths(drv, {})
    log(f"[lifecycle] (a) config 6 first audit: {len(want)} results, "
        f"{first:.3f} s; host (cold): {paths.get('interp', [])}; device "
        f"(blocked on the warm): {paths.get('device', [])}; warm_status "
        f"{drv.warm_status()}")
    drain, rounds = warm_rounds("(a) config 6", drv, audit, want)
    el, paths2, _drain, _k2 = rounds[-1]
    check(paths2 == {"device": sorted(drv._programs)},
          f"config 6's warm audit paths {paths2}")
    # the foreground's own sample: taken, not dropped for a compile
    lat = drv.last_audit_lat_s
    check(lat is not None and lat[0] is not None,
          f"the warm audit's latency sample was dropped: {lat}")
    log(f"[lifecycle] (a) warm audit: {len(want)} results, {el:.3f} s, "
        f"all {len(paths2['device'])} compiled kinds on the card, 0 "
        f"foreground compiles; latency sample {lat[0]:.6f} s entered the "
        f"EMA ({drv._dev_batch_lat_s:.6f} s)")
    st = drv.warm_status()["aot"]
    n_sigs = sum(len(drv.aot.sigs_for(drv.compiled_for(k).fingerprint))
                 for k in drv._programs)
    check(st["fresh"] > 0 and drv.aot.programs_count() > 0 and n_sigs > 0,
          f"(a) stored nothing: {st}, {n_sigs} sigs")
    log(f"[lifecycle] (a) program store: {drv.aot.programs_count()} K2 "
        f"variants, {n_sigs} sweep signatures; acquisitions "
        + json.dumps({k: v for k, v in st.items() if k != "dir"}))
    rec.update(config6_first_s=first, config6_drain_s=drain,
               config6_stored=drv.aot.programs_count(),
               config6_stored_sigs=n_sigs,
               config6_first_host_kinds=len(paths.get("interp", [])),
               config6_rounds=[(r[0], r[2], len(r[1].get("interp", [])))
                               for r in rounds],
               config6_sample_s=lat[0])


def lifecycle_config4(rec: dict) -> None:
    """(b) config 4 (about 50 M masked pairs, far over the 30 s host
    estimate): the first audit blocks on the warm and takes the card."""
    from gatekeeper_tpu_torch.ir import TorchDriver
    from gatekeeper_tpu_torch.kernels import build as kernel_build

    drv = TorchDriver()
    client = flagship(drv, CONFIG4[0])
    settle()
    fg = kernel_build.thread_compiles()
    t0 = time.perf_counter()
    res = client.audit().results()
    first = time.perf_counter() - t0
    paths = kind_paths(drv, {})
    check(len(res) == CONFIG4_RESULTS, f"config 4 with async warm: "
          f"{len(res)} results, want {CONFIG4_RESULTS}")
    check(paths == {"device": ["K8sRequiredLabels"]} and
          not drv.quarantine_status() and not drv._quarantine_hist,
          f"config 4's first audit paths {paths}, quarantined "
          f"{drv.quarantine_status()}")
    warm = drv.warm_status()
    check(kernel_build.thread_compiles() == fg and
          (warm["warm"], warm["compiling"]) == (1, 0),
          f"config 4: foreground compiles "
          f"{kernel_build.thread_compiles() - fg}, {drv.warm_status()}")
    log(f"[lifecycle] (b) config 4 first audit: {len(res)} results, "
        f"{first:.3f} s, blocked on the warm, then the card (0 foreground "
        "compiles)")
    rec.update(config4_first_s=first)


def lifecycle_batch(rec: dict) -> None:
    """(c) the 512-manifest dense batch, pinned to the card (the gate as
    phase 9 pins it): cold dense signatures serve the host
    (_ServeHostThisRound) while they warm; after the drain, rounds until
    no shape is cold (warm_rounds), the last with every compiled kind on
    K2 and no compile on the serving thread. Every batch equals the
    interpreter."""
    from gatekeeper_tpu_torch.client import RegoDriver
    from gatekeeper_tpu_torch.ir import TorchDriver
    from gatekeeper_tpu_torch.kernels import build as kernel_build

    drv = TorchDriver()
    client = library_client(drv, compiled_only=False)
    oracle = library_client(RegoDriver(), compiled_only=False)
    for o in corpus(2000):
        client.add_data(o)
        oracle.add_data(o)
    objs = corpus(512)
    want = [result_key(r.results()) for r in oracle.review_batch(objs)]
    settle()

    drv._use_device_for_batch = lambda n: True

    def batch():
        return [result_key(r.results()) for r in client.review_batch(objs)]

    fg = kernel_build.thread_compiles()
    t0 = time.perf_counter()
    got = batch()
    cold = time.perf_counter() - t0
    paths = kind_paths(drv, {})
    check(got == want, "the cold 512 batch differs from the interpreter")
    check(kernel_build.thread_compiles() == fg and "device" not in paths,
          f"the cold 512 batch compiled or took the card: {paths}")
    log(f"[lifecycle] (c) 512 batch, cold: {cold:.3f} s, equal to the "
        "interpreter; per kind: " + "; ".join(
            f"{p} {ks}" for p, ks in paths.items())
        + f"; warm_status {drv.warm_status()}")
    drain, rounds = warm_rounds("(c) 512 batch", drv, batch, want)
    el, paths2, _drain, k2 = rounds[-1]
    dense = sorted(k for k in paths["interp"]
                   if drv._compiled.get(k) is not None)
    check(len(dense) > 1 and paths2.get("device") == dense and k2 > 0,
          f"the warm 512 batch: paths {paths2}, K2 {k2}; the compiled "
          f"kinds {dense} must all take the card")
    log(f"[lifecycle] (c) warm 512 batch: {el:.3f} s, all {len(dense)} "
        f"compiled kinds on K2 ({k2} launches), 0 foreground compiles")
    rec.update(batch512_cold_s=cold, batch512_drain_s=drain,
               batch512_rounds=[(r[0], r[2], len(r[1].get("device", [])))
                                for r in rounds])


def lifecycle_quarantine(rec: dict) -> None:
    """(d) quarantine on the card: eval.device injected for a review-pure
    kind and a RuntimeError from the K4 wrapper for a join kind; 332
    results throughout; both kinds quarantined (fails 1), no launch of
    either while benched; after the faults clear and the backoff
    passes, the probe restores the card."""
    from collections import Counter

    from gatekeeper_tpu_torch.ir import TorchDriver, evaltorch
    from gatekeeper_tpu_torch.ir import join as tjoin
    from gatekeeper_tpu_torch.parallel.workload import synth_mixed_objects
    from gatekeeper_tpu_torch.utils.faults import FAULTS

    bad_pure, bad_join = LIFECYCLE_BAD
    want = GENERAL_RESULTS[10_000]
    drv = TorchDriver()
    # long enough that the second audit runs inside the backoff however
    # slow the host (the faulted audit, which the backoff's first
    # seconds overlap, took 14.7-24.3 s on the card's host beside the
    # smoke's other processes); the probe is let in by expiring it
    # (below)
    drv.quarantine_base_s = drv.quarantine_max_s
    client = general_client(drv)
    for o in synth_mixed_objects(10_000):
        client.add_data(o)
    settle()
    check(len(client.audit().results()) == want, "warm-up audit count")
    wait_warm(drv)
    # launches per kind: K2 through the template's words, K4 through the
    # join's device path, where a stand-in of the K4 wrapper raises for
    # the faulted join kind while armed
    launches: Counter = Counter()
    k4_calls: Counter = Counter()  # the stand-in's calls, failed ones too
    armed = [True]
    current = [None]
    words, fires_device, k4 = (evaltorch.CompiledTemplate.words,
                               tjoin.JoinCompiled._fires_device,
                               tjoin.join_member)

    def counted_words(self, *a, **k):
        launches[("K2", self.kind)] += 1
        return words(self, *a, **k)

    def kind_fires_device(self, *a, **k):
        current[0] = self.kind
        try:
            return fires_device(self, *a, **k)
        finally:
            current[0] = None

    def failing_k4(*a, **k):
        k4_calls[current[0]] += 1
        if armed[0] and current[0] == bad_join:
            raise RuntimeError("join_member kernel launch failed: CUDA "
                               "error 9 (injected)")
        launches[("K4", current[0])] += 1
        return k4(*a, **k)

    evaltorch.CompiledTemplate.words = counted_words
    tjoin.JoinCompiled._fires_device = kind_fires_device
    tjoin.join_member = failing_k4
    FAULTS.inject("eval.device", match={"kind": bad_pure})
    try:
        drv._audit_results_cache.clear()
        t0 = time.perf_counter()
        n1 = len(client.audit().results())
        t1 = time.perf_counter() - t0
        q = drv.quarantine_status()
        check(n1 == want, f"the faulted audit returned {n1}, want {want}")
        check(sorted(q) == sorted(LIFECYCLE_BAD) and
              all(v["fails"] == 1 for v in q.values()),
              f"quarantine after the faulted audit: {q}")
        log(f"[lifecycle] (d) faulted audit: {n1} results, {t1:.3f} s; "
            "quarantined: " + "; ".join(f"{k} (fails {v['fails']}, "
                                        f"{v['reason']})"
                                        for k, v in sorted(q.items())))
        # inside the backoff: neither kind may try the card, so neither
        # the fault point nor the K4 stand-in is reached for it again
        before = dict(launches)
        fired, calls = FAULTS.fired("eval.device"), k4_calls[bad_join]
        check(all(v["remaining_s"] > 30 for v in q.values()),
              f"the backoff ran out before the second audit: {q}")
        t0 = time.perf_counter()
        n2 = len(client.audit().results())
        t2 = time.perf_counter() - t0
        q = drv.quarantine_status()
        check(n2 == want, f"the second faulted audit returned {n2}")
        check(FAULTS.fired("eval.device") == fired and
              k4_calls[bad_join] == calls,
              f"a benched kind tried the card: eval.device fired "
              f"{FAULTS.fired('eval.device') - fired}, the K4 stand-in "
              f"called {k4_calls[bad_join] - calls} times for {bad_join}")
        for kind, k in ((bad_pure, "K2"), (bad_join, "K4")):
            check(launches[(k, kind)] == before.get((k, kind), 0),
                  f"{kind} launched {k} while quarantined")
        check(sorted(q) == sorted(LIFECYCLE_BAD) and
              all(v["fails"] == 1 and v["remaining_s"] > 0
                  for v in q.values()),
              f"quarantine after the second audit: {q}")
        log(f"[lifecycle] (d) second audit, inside the backoff: {n2} "
            f"results, {t2:.3f} s, neither kind tried the card (fault "
            f"fired {fired}, K4 stand-in calls {calls} for {bad_join}); "
            f"fails {[q[k]['fails'] for k in LIFECYCLE_BAD]}")
        FAULTS.clear("eval.device")
        armed[0] = False
        # the backoff runs out: the breaker half-opens
        with drv._quarantine_lock:
            for ent in drv._quarantine.values():
                ent["until"] = time.monotonic()
        # the cost model prefers the card (the JAX package's own test
        # pins it so), so that the probe sweeps there
        drv._dev_batch_lat_s = 1e-4
        drv._host_pair_rate = 1.0
        before = dict(launches)
        t0 = time.perf_counter()
        n3 = len(client.audit().results())
        t3 = time.perf_counter() - t0
        check(n3 == want, f"the probe audit returned {n3}")
        check(drv.quarantine_status() == {},
              f"after the probe: {drv.quarantine_status()}")
        for kind, k in ((bad_pure, "K2"), (bad_join, "K4")):
            check(launches[(k, kind)] > before.get((k, kind), 0),
                  f"the probe did not launch {k} for {kind}")
        log(f"[lifecycle] (d) probe audit: {n3} results, {t3:.3f} s; "
            "both kinds restored to the card, quarantine_status() {}")
    finally:
        FAULTS.clear("eval.device")
        evaltorch.CompiledTemplate.words = words
        tjoin.JoinCompiled._fires_device = fires_device
        tjoin.join_member = k4
    wait_warm(drv)
    rec.update(quarantine_audits_s=[t1, t2, t3])


def phase_lifecycle(dev, report: dict, aot_dir: str):
    """Phase 15: the compile lifecycle with async warm on (the package
    default), in a Triton cache of its own under _build/ and with the
    generated K2 modules forgotten, so that its compiles are real; (a)
    fills the program store at `aot_dir`, and phase 16's child, which
    boots on it, starts as soon as (a) is done and runs beside (b)-(d).
    Returns that child (phase_warm_boot waits for it)."""
    build = os.path.join(ROOT, "gatekeeper_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    rec: dict = {}
    child = None
    saved = os.environ.get("TRITON_CACHE_DIR")
    try:
        with tempfile.TemporaryDirectory(prefix="triton-", dir=build) as tc:
            os.environ["TRITON_CACHE_DIR"] = tc
            forget_k2_modules()
            try:
                for part, fn in (("a", lambda r: lifecycle_config6(r, aot_dir)),
                                 ("b", lifecycle_config4),
                                 ("c", lifecycle_batch),
                                 ("d", lifecycle_quarantine)):
                    t0 = time.perf_counter()
                    fn(rec)
                    rec[f"{part}_s"] = time.perf_counter() - t0
                    log(f"[lifecycle] ({part}) {rec[f'{part}_s']:.1f} s")
                    settle(release=True)  # the part's driver, frozen
                    if part == "a":
                        child = warm_boot_child(aot_dir)
            finally:
                if saved is None:
                    os.environ.pop("TRITON_CACHE_DIR", None)
                else:
                    os.environ["TRITON_CACHE_DIR"] = saved
            log(f"[lifecycle] Triton cache of the phase: "
                f"{len(os.listdir(tc))} entries")
    except BaseException:
        if child is not None:
            child.stop()
        raise
    report["lifecycle"] = rec
    return child


def warm_boot(aot_dir: str) -> dict:
    """Phase 16's child: a new process with an empty Triton cache boots
    config 6 on the program store phase 15 (a) filled, with async warm
    on (the package default). It waits for the prewarm to adopt every
    stored sweep signature of the 16 kinds, then runs the first audit:
    29,448 results with every kind on the card and none on the
    interpreter, no fresh or cache compile in the process (every K2
    variant came from the store, "aot" at least once per kind), and no
    compile off the driver's warm and prewarm threads."""
    from gatekeeper_tpu_torch.ir import TorchDriver, aot
    from gatekeeper_tpu_torch.kernels import build as kernel_build
    from gatekeeper_tpu_torch.kernels.clause import clause_words
    from gatekeeper_tpu_torch.parallel.workload import synth_pods_psp

    counts0 = dict(aot.COMPILE_COUNTS)
    compiles0 = kernel_build.compiles_by_thread()
    t0 = time.perf_counter()
    drv = TorchDriver(aot_dir=aot_dir)
    check(drv.aot.enabled, f"the program store at {aot_dir} is disabled")
    check(drv.async_warm, "async warm is not the package default")
    stored = drv.aot.programs_count()
    check(stored > 0, f"the program store at {aot_dir} holds no program")
    quarantined: list = []
    drv.on_quarantine = lambda kind, reason: quarantined.append(
        (kind, reason))
    client = psp_client(drv, synth_pods_psp(LIFECYCLE_PODS))
    settle()  # a server freezes its heap once loaded
    kinds = sorted(drv._programs)
    sigs = {k: drv.aot.sigs_for(drv.compiled_for(k).fingerprint)
            for k in kinds}
    check(len(kinds) == 16 and all(sigs.values()),
          f"kinds without a stored sweep signature: "
          f"{[k for k in kinds if not sigs[k]]}")
    n_sigs = sum(len(v) for v in sigs.values())
    built = time.perf_counter() - t0
    adopt_s = wait_for(lambda: drv.warm_status()["warm"] >= n_sigs, 300,
                       f"the prewarm did not adopt the {n_sigs} stored "
                       "sweep signatures")
    loaded = {k: sum(ev["source"] == "aot" for ev in drv.aot.events_for(k))
              for k in kinds}
    check(all(loaded.values()), f"kinds with no stored variant loaded: "
          f"{[k for k in kinds if not loaded[k]]}")
    k2 = clause_words.launches
    t2 = time.perf_counter()
    got = client.audit().results()
    first = time.perf_counter() - t2
    paths = kind_paths(drv, {})
    counts = {k: aot.COMPILE_COUNTS[k] - counts0.get(k, 0)
              for k in aot.COMPILE_COUNTS}
    check(len(got) == LIFECYCLE_RESULTS, f"the warm boot's first audit "
          f"returned {len(got)} results, want {LIFECYCLE_RESULTS}")
    check(paths == {"device": kinds}, f"the warm boot's first audit "
          f"paths {paths}: every kind must take the card")
    check(counts["fresh"] == 0 and counts["cache"] == 0 and
          counts["error"] == 0 and counts["aot"] >= len(kinds),
          f"the warm boot compiled: {counts}")
    check(not serving_compiles(compiles0), f"compiles off the warm "
          f"threads: {serving_compiles(compiles0)}")
    check(not quarantined and not drv.quarantine_status(),
          f"quarantined in the warm boot: {quarantined}")
    return dict(first_s=first, build_s=built, adopt_s=adopt_s,
                results=len(got), stored=stored, sigs=n_sigs,
                k2_launches=clause_words.launches - k2, counts=counts,
                aot_per_kind=loaded, device_kinds=len(paths["device"]))


class ChildProcess:
    """A child process of this script (`python3 chip_smoke.py ARGS`),
    started at once, with the environment variables `drop` unset and,
    with `triton`, an empty Triton cache of its own; its output goes to
    files in a directory of its own under _build/."""

    def __init__(self, prefix: str, args: list, triton: bool = False,
                 drop=("GATEKEEPER_TPU_ASYNC_COMPILE",
                       "GATEKEEPER_TPU_AOT_DIR")):
        build = os.path.join(ROOT, "gatekeeper_tpu_torch", "_build")
        os.makedirs(build, exist_ok=True)
        self.dir = tempfile.mkdtemp(prefix=prefix, dir=build)
        env = dict(os.environ)
        for var in drop:
            env.pop(var, None)
        self.triton = None
        if triton:
            self.triton = env["TRITON_CACHE_DIR"] = os.path.join(
                self.dir, "triton")
            os.makedirs(self.triton)
        self.out = open(os.path.join(self.dir, "stdout"), "w+")
        self.err = open(os.path.join(self.dir, "stderr"), "w+")
        self.t0 = time.perf_counter()
        self.ended: list = []
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *args], env=env,
            stdout=self.out, stderr=self.err)
        self.waiter = threading.Thread(
            target=lambda: (self.proc.wait(),
                            self.ended.append(time.perf_counter())),
            daemon=True)
        self.waiter.start()

    def wait(self, timeout: float, what: str) -> tuple:
        """(exit code, stdout lines, stderr lines, seconds from start to
        exit, entries left in its Triton cache or None); kills the child
        past `timeout` s from its start."""
        self.waiter.join(max(0.0, timeout - (time.perf_counter() - self.t0)))
        if not self.ended:
            self.stop()
            raise Fail(f"{what} ran past {timeout} s")
        lines = []
        for f in (self.out, self.err):
            f.seek(0)
            lines.append(f.read().strip().splitlines())
        left = None if self.triton is None else len(os.listdir(self.triton))
        self.stop()
        return self.proc.returncode, lines[0], lines[1], \
            self.ended[0] - self.t0, left

    def stop(self) -> None:
        """Kills the child if it still runs and removes its files; again
        does nothing."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.out.close()
        self.err.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def child_exit(code: int, err: list) -> str:
    """"exited CODE" with the reason a failed child gave: the message of
    its own `chip_smoke: FAILED:` line, else its last stderr line (an
    uncaught exception's), so that the smoke's one failure line on
    stderr says what failed inside the child."""
    failed = [ln for ln in err if ln.startswith("chip_smoke: FAILED: ")]
    why = (failed[-1][len("chip_smoke: FAILED: "):] if failed
           else err[-1] if err else "")
    return f"exited {code}" + (f" ({why})" if why and code else "")


def warm_boot_child(aot_dir: str) -> ChildProcess:
    """Phase 16's child process (warm_boot, `--warm-boot DIR`) with an
    empty Triton cache of its own."""
    return ChildProcess("warmboot-", ["--warm-boot", aot_dir], triton=True)


def phase_warm_boot(dev, report: dict, child: ChildProcess) -> None:
    """Phase 16: waits for the warm boot's child (warm_boot), started
    beside phase 15 (b)-(d), and prints its first audit's wall clock
    beside phase 15 (a)'s."""
    code, out, err, el, left = child.wait(900, "the warm-boot child")
    for line in (out[:-1] if code == 0 else out):
        log(f"[warm boot] child: {line}")
    for line in err[-40:]:
        log(f"[warm boot] child stderr: {line}")
    check(code == 0 and out, f"the warm-boot child {child_exit(code, err)}")
    rec = json.loads(out[-1])["warm_boot"]
    rec["child_s"] = el
    rec["triton_cache_entries"] = left
    a = report["lifecycle"]["config6_first_s"]
    log(f"[warm boot] config 6's first audit on the stored programs: "
        f"{rec['first_s']:.3f} s ({rec['results']} results, all "
        f"{rec['device_kinds']} kinds on the card, {rec['k2_launches']} K2 "
        f"launches, compile counts {rec['counts']}); phase 15 (a)'s first "
        f"audit in this call {a:.3f} s; the child took {el:.1f} s beside "
        f"phase 15 (b)-(d) (config 6 built in {rec['build_s']:.1f} s, the "
        f"prewarm adopted {rec['sigs']} sweep signatures "
        f"{rec['adopt_s']:.1f} s after)")
    report["warm_boot"] = rec


# phase 17: the process entry point (control/main.py's Runtime) booted
# cold, then warm on the state its drain snapshot wrote, on BENCH config
# 9's cluster (parallel/workload.py entry_cluster) cut from 50,000 pods to
# 25,000 as phases 15 and 16 are
ENTRY_PODS = 25_000
# per constraint, the status totalViolations the JAX package's Runtime
# writes on this cluster with its device path forced
# (tests/torch_reference_counts.py --runtime 25000, `totals`): config 6's
# 29,448 at 25,000 pods, seccomp on each of the 40 Namespaces, which the
# audit manager lists too, and selinux on them as well: both packages'
# compiled K8sPSPSELinux takes an object without a spec for a bearer,
# and their interpreters do not (ENTRY_HOST_TOTALS, the JAX package's
# RegoDriver: `host_totals`), so a kind's total depends on its path
ENTRY_TOTALS = {
    "K8sPSPAllowPrivilegeEscalationContainer/no-escalation": 157,
    "K8sPSPAppArmor/apparmor-default": 0,
    "K8sPSPCapabilities/caps": 234,
    "K8sPSPFlexVolumes/flex": 0,
    "K8sPSPForbiddenSysctls/sysctls": 3572,
    "K8sPSPFSGroup/fsgroup": 0,
    "K8sPSPHostFilesystem/hostfs": 0,
    "K8sPSPHostNamespace/no-host-ns": 0,
    "K8sPSPHostNetworkingPorts/host-ports": 0,
    "K8sPSPPrivilegedContainer/no-privileged": 157,
    "K8sPSPProcMount/procmount": 0,
    "K8sPSPReadOnlyRootFilesystem/ro-root": 157,
    "K8sPSPSeccomp/seccomp": 40,
    "K8sPSPSELinux/selinux": 25040,
    "K8sPSPAllowedUsers/users": 171,
    "K8sPSPVolumeTypes/volumes": 0,
}
ENTRY_HOST_TOTALS = {**ENTRY_TOTALS, "K8sPSPSELinux/selinux": 25000}
ENTRY_REVIEWS = 64
ENTRY_SECTIONS = ("vocab.snapshot.json", "library.snapshot.json",
                  "inventory.snapshot.blob", "rows.snapshot.blob")
POD_GVK = ("", "v1", "Pod")


def http_call(port: int, method: str, path: str, body=None) -> tuple:
    """(status, body bytes) of one request to 127.0.0.1:port."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        return http_request(conn, method, path, body)
    finally:
        conn.close()


def audit_traces() -> list:
    """The audit sweeps' finished traces in the flight recorder."""
    from gatekeeper_tpu_torch.control import trace as gtrace

    return gtrace.TRACER.recorder.dump()["planes"].get(
        "audit", {}).get("recent", [])


def sweep_trace(trace: dict) -> dict:
    """A sweep's trace: its status, its seconds and per stage the
    seconds of its spans."""
    spans: dict = {}
    for sp in trace["spans"]:
        spans[sp["stage"]] = spans.get(sp["stage"], 0.0) + sp["duration_s"]
    return {"status": trace["status"], "duration_s": trace["duration_s"],
            "spans": spans}


def entry_statuses(kube) -> dict:
    """Per PSP constraint its status's totalViolations and entries."""
    out = {}
    for (kind, name), st in constraint_statuses(kube,
                                                entry_kinds()).items():
        out[f"{kind}/{name}"] = [st.get("totalViolations"),
                                 st.get("violations")]
    return out


def entry_mismatch(kube, drv, counts0: dict) -> dict:
    """The constraints whose status total differs from the JAX
    package's on the path its kind took since `counts0` (eval_counts):
    ENTRY_TOTALS on the card, ENTRY_HOST_TOTALS on the interpreter,
    either for a kind the delta cache served (its results come from an
    earlier sweep)."""
    by_kind = {k: p for p, ks in kind_paths(drv, counts0).items()
               for k in ks}
    bad = {}
    for c, (total, _entries) in entry_statuses(kube).items():
        path = by_kind.get(c.split("/")[0])
        refs = {"device": [ENTRY_TOTALS[c]],
                "interp": [ENTRY_HOST_TOTALS[c]]}.get(
                    path, [ENTRY_TOTALS[c], ENTRY_HOST_TOTALS[c]])
        if total not in refs:
            bad[c] = [total, path, refs]
    return bad


def status_diff(a: dict, b: dict) -> dict:
    """Per constraint where two entry_statuses differ: both totals, both
    entry counts and the first pair of entries that differ."""
    out = {}
    for c in sorted(set(a) | set(b)):
        x, y = a.get(c) or [None, []], b.get(c) or [None, []]
        if x == y:
            continue
        xs, ys = x[1] or [], y[1] or []
        first = next(([p, q] for p, q in zip(xs, ys) if p != q), None)
        out[c] = {"totals": [x[0], y[0]], "entries": [len(xs), len(ys)],
                  "first": first}
    return out


def entry_kinds() -> list:
    from gatekeeper_tpu_torch.parallel.workload import PSP_CONSTRAINTS

    return sorted({k for k, _n, _p in PSP_CONSTRAINTS})


def entry_runtime(state_dir: str):
    """Seeds a FakeKube with BENCH config 9's cluster at ENTRY_PODS (both
    children write the same objects in the same order, so every object
    has the same resourceVersion) and builds the port's Runtime on it
    with the deployment's flags (ENTRY_FLAGS), the device left at its
    default and a metrics port of its own, the kernels' launch counters
    zeroed just before. Returns (kube, pods, runtime, the clock at
    Runtime(...), the kube's calls before it)."""
    from gatekeeper_tpu_torch import policies
    from gatekeeper_tpu_torch.control.kube import FakeKube
    from gatekeeper_tpu_torch.control.main import Runtime, build_parser
    from gatekeeper_tpu_torch.parallel.workload import (
        ENTRY_FLAGS, entry_cluster)

    kube = FakeKube()
    pods = entry_cluster(kube, [
        policies.load(name) for name in policies.names()
        if name.startswith("pod-security-policy/")], ENTRY_PODS)
    args = build_parser().parse_args(
        ENTRY_FLAGS + ["--state-dir", state_dir, "--prometheus-port", "0"])
    check(args.device == "cuda", f"--device defaults to "
          f"{args.device!r}")
    settle()
    for w in kernel_wrappers().values():
        w.launches = 0
    calls0 = len(kube.calls)
    t0 = time.perf_counter()
    rt = Runtime(args, kube=kube)
    check(rt.opa.driver.device.type == "cuda",
          f"the Runtime's driver is on {rt.opa.driver.device}")
    return kube, pods, rt, t0, calls0


def wait_ready(rt, t0: float) -> float:
    """Seconds from `t0` (Runtime(...)) to the first 200 of /readyz."""
    wait_for(lambda: http_call(rt.health.port, "GET", "/readyz")[0] == 200,
             600, "/readyz never answered 200")
    return time.perf_counter() - t0


def entry_quarantine(drv) -> None:
    check(not drv.quarantine_status() and not drv._quarantine_hist,
          f"quarantined: {drv.quarantine_status()}, history "
          f"{sorted(drv._quarantine_hist)}")


def entry_cold(state_dir: str) -> dict:
    """Phase 17 (a), the child `--entry cold DIR`: the Runtime boots on
    the seeded kube; its controllers ingest the library and its audit
    loop sweeps at once (the first sweep: its trace and the kinds it
    found ingested). Time to /readyz 200; after the controllers drain, a
    sweep (audit_once) whose statuses hold the JAX package's totals per
    constraint on each kind's path (entry_mismatch);
    once the warm has drained, sweeps over the cached features (the
    delta cache emptied) until no shape is cold, the last with every
    kind on the card; ENTRY_REVIEWS pods as AdmissionReviews to /v1/admit,
    each body byte-equal to the port's interpreter's verdict; /metrics
    with the snapshot and SLO series; then stop(), whose drain snapshot
    must write every section and the program store. K1 and K2 launch."""
    from gatekeeper_tpu_torch.client import RegoDriver
    from gatekeeper_tpu_torch.control import trace as gtrace
    from gatekeeper_tpu_torch.control.webhook import (
        encode_envelope, verdict_response)
    from gatekeeper_tpu_torch.kernels import build as kernel_build

    compiles0 = kernel_build.compiles_by_thread()
    gtrace.TRACER.recorder.clear()
    kube, pods, rt, t0, _calls0 = entry_runtime(state_dir)
    drv = rt.opa.driver
    built = time.perf_counter() - t0
    rec: dict = {"build_s": built}
    try:
        rt.start()
        rec["ready_s"] = wait_ready(rt, t0)
        # the audit loop's own first sweep, started by start() beside the
        # controllers' ingest: the kinds ingested when it evaluated took
        # a path
        wait_for(lambda: audit_traces(), 600, "the audit loop's first "
                 "sweep did not end")
        (trace,) = audit_traces()
        rec["first"] = {**sweep_trace(trace),
                        "stats": dict(rt.audit.last_sweep_stats),
                        "paths": kind_paths(drv, {})}
        rec["first_s"] = trace["duration_s"]
        t1 = time.perf_counter()
        rt.manager.drain()
        rec["drain_s"] = time.perf_counter() - t1
        kinds = sorted(drv._programs)
        check(kinds == entry_kinds(), f"device kinds {kinds}")
        counts0 = drv.eval_counts()
        t1 = time.perf_counter()
        results = rt.audit.audit_once()
        rec["after_drain_s"] = time.perf_counter() - t1
        bad = entry_mismatch(kube, drv, counts0)
        check(not bad, f"cold sweep: {len(results)} results; totals "
              f"unlike the JAX package's on their path: {bad}")
        log(f"[entry] (a) cold boot: ready {rec['ready_s']:.3f} s after "
            f"Runtime(...) (built in {built:.3f} s); the audit loop's "
            f"first sweep {rec['first_s']:.3f} s "
            f"({rec['first']['stats']}), its trace phases: "
            + ", ".join(f"{k} {v:.3f} s"
                        for k, v in rec["first"]["spans"].items())
            + f"; paths {rec['first']['paths']}; the controllers drained "
            f"{rec['drain_s']:.3f} s later; the sweep after it "
            f"{rec['after_drain_s']:.3f} s, {len(results)} results, every "
            f"constraint's total equal to the JAX package's on its kind's "
            f"path {kind_paths(drv, counts0)}")

        def sweep():
            c0 = drv.eval_counts()
            rt.audit.audit_once()
            return entry_mismatch(kube, drv, c0)

        _drain, rounds = warm_rounds("(a) entry", drv, sweep, {})
        el, paths, _d, k2 = rounds[-1]
        totals = {k: v[0] for k, v in entry_statuses(kube).items()}
        check(paths == {"device": kinds} and totals == ENTRY_TOTALS,
              f"the cold boot's last sweep: paths {paths}, totals {totals}")
        rec["rounds"] = [(r[0], r[2], r[1]) for r in rounds]
        log(f"[entry] (a) sweep on the card: {el:.3f} s, all {len(kinds)} "
            f"kinds on the card, {k2} K2 launches")
        # admission: violators first, then pods with the selinux total
        # alone, as CREATE AdmissionReviews
        flagged = {(r.resource or {}).get("metadata", {}).get("name")
                   for r in results
                   if r.constraint["kind"] != "K8sPSPSELinux"}
        picked = [p for p in pods if p["metadata"]["name"] in flagged][
            :ENTRY_REVIEWS // 2]
        picked += [p for p in pods if p["metadata"]["name"] not in flagged][
            :ENTRY_REVIEWS - len(picked)]
        oracle = psp_client(RegoDriver(), ())
        want = []
        for i, resp in enumerate(oracle.review_batch(picked)):
            body = verdict_response([(r.enforcement_action, r.msg)
                                     for r in resp.results()])
            body["uid"] = f"entry-{i}"
            want.append(encode_envelope({
                "apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview", "response": body}))
        got: list = [None] * len(picked)

        def post(i: int) -> None:
            pod = picked[i]
            got[i] = http_call(rt.webhook.port, "POST",
                               "/v1/admit?timeout=30s", json.dumps({
                                   "apiVersion": "admission.k8s.io/v1",
                                   "kind": "AdmissionReview",
                                   "request": {
                                       "uid": f"entry-{i}",
                                       "operation": "CREATE",
                                       "kind": {"group": "", "version": "v1",
                                                "kind": "Pod"},
                                       "name": pod["metadata"]["name"],
                                       "namespace":
                                           pod["metadata"]["namespace"],
                                       "userInfo": {"username":
                                                    "chip-smoke"},
                                       "object": pod}}))

        t1 = time.perf_counter()
        posters = [threading.Thread(target=post, args=(i,))
                   for i in range(len(picked))]
        for t in posters:
            t.start()
        for t in posters:
            t.join(120)
        rec["admit_s"] = time.perf_counter() - t1
        bad = [i for i, (g, w) in enumerate(zip(got, want))
               if g is None or g[0] != 200 or g[1] != w]
        check(not bad, f"{len(bad)} of {len(picked)} /v1/admit bodies "
              f"differ from the interpreter's verdict; first: "
              f"{got[bad[0]] if bad else None!r:.600} want "
              f"{want[bad[0]] if bad else None!r:.600}")
        denied = sum(b'"allowed":false' in g[1] for g in got)
        log(f"[entry] (a) /v1/admit: {len(picked)} AdmissionReviews "
            f"({denied} denied) in {rec['admit_s']:.3f} s, every body "
            "byte-equal to the interpreter's verdict")
        status, text = http_call(rt.metrics_server.server_address[1],
                                 "GET", "/metrics")
        text = text.decode()
        series = ("gatekeeper_tpu_snapshot_restore_total",
                  "gatekeeper_tpu_slo_burn_rate", "gatekeeper_tpu_slo_target")
        check(status == 200 and all(s in text for s in series),
              f"/metrics ({status}) lacks {[s for s in series if s not in text]}")
        entry_quarantine(drv)
        rec["serving_compiles"] = serving_compiles(compiles0)
        with open(os.path.join(os.path.dirname(state_dir),
                               "cold_statuses.json"), "w") as f:
            json.dump(entry_statuses(kube), f)
    finally:
        t1 = time.perf_counter()
        rt.stop()
        rec["stop_s"] = time.perf_counter() - t1
    left = sorted(os.listdir(state_dir))
    check(all(s in left for s in ENTRY_SECTIONS) and "aot" in left
          and drv.aot.programs_count() > 0,
          f"the drain snapshot left {left}, "
          f"{drv.aot.programs_count()} stored programs")
    rec["state_bytes"] = {s: os.path.getsize(os.path.join(state_dir, s))
                          for s in ENTRY_SECTIONS}
    rec["stored_programs"] = drv.aot.programs_count()
    rec["launches"] = launch_counts()
    check(rec["launches"]["K1"] > 0 and rec["launches"]["K2"] > 0,
          f"the cold boot launched {rec['launches']}")
    log(f"[entry] (a) stop: drain snapshot {rec['stop_s']:.3f} s, "
        f"sections {rec['state_bytes']} bytes, "
        f"{rec['stored_programs']} K2 variants stored; launches "
        f"{rec['launches']}; compiles off the warm threads "
        f"{rec['serving_compiles']}")
    return rec


def entry_warm(state_dir: str) -> dict:
    """Phase 17 (b), the child `--entry warm DIR`, in an empty Triton
    cache of its own: a new process boots the same seeded kube on (a)'s
    state dir as `main()` does, `Runtime(...)` and at once `start()`. The
    Runtime restores the vocabulary, the library, the inventory and the
    tracker without a restore fallback, and starts its audit loop once
    the rows are loaded and the prewarm has run (control/main.py
    _start_audit); /readyz holds until the loop's first sweep
    re-validates. That sweep must be incremental with 0 dirty, list no
    Pods, adopt the restored rows of every kind, run every kind on the
    card with no fresh or cache compile in the process ("aot" at least
    once a kind) and none off the warm threads, and leave in the kube
    (a)'s statuses. K2 launches."""
    from gatekeeper_tpu_torch.control import metrics
    from gatekeeper_tpu_torch.control import trace as gtrace
    from gatekeeper_tpu_torch.control.main import RESTORE_GATE_S
    from gatekeeper_tpu_torch.ir import aot
    from gatekeeper_tpu_torch.kernels import build as kernel_build

    compiles0 = kernel_build.compiles_by_thread()
    counts0 = dict(aot.COMPILE_COUNTS)
    gtrace.TRACER.recorder.clear()
    kube, _pods, rt, t0, calls0 = entry_runtime(state_dir)
    drv = rt.opa.driver

    def restores(outcome: str) -> float:
        return metrics.REGISTRY._metrics[
            "gatekeeper_tpu_snapshot_restore_total"].values.get(
                metrics._lv({"outcome": outcome}), 0.0)

    rec: dict = {"build_s": time.perf_counter() - t0}
    try:
        rt.start()
        check(rt.audit.tracker is not None, "the inventory was not restored")
        kinds = sorted(drv._programs)
        check(kinds == entry_kinds(), f"restored device kinds {kinds}")
        sigs = sum(len(drv.aot.sigs_for(drv.compiled_for(k).fingerprint))
                   for k in kinds)
        check(sigs > 0, "no stored sweep signature")
        rec["ready_s"] = wait_ready(rt, t0)
        wait_for(lambda: audit_traces(), 600, "the audit loop's first "
                 "sweep did not end")
        (trace,) = audit_traces()
        rec["gate_s"] = rt.restore_gate_s
        rec["first"] = {**sweep_trace(trace),
                        "stats": dict(rt.audit.last_sweep_stats),
                        "paths": kind_paths(drv, {})}
        rec["first_s"] = trace["duration_s"]
        stats = rec["first"]["stats"]
        pod_lists = [c for c in kube.calls[calls0:]
                     if c[0] == "list" and c[1] == POD_GVK and c[2] is None]
        counts = {k: aot.COMPILE_COUNTS[k] - counts0.get(k, 0)
                  for k in aot.COMPILE_COUNTS}
        loaded = {k: sum(ev["source"] == "aot"
                         for ev in drv.aot.events_for(k)) for k in kinds}
        with open(os.path.join(os.path.dirname(state_dir),
                               "cold_statuses.json")) as f:
            cold = json.load(f)
        warm = entry_statuses(kube)
        rec.update(counts=counts, aot_per_kind=loaded, sigs=sigs,
                   rows_adopted=drv.restored_rows_adopted,
                   adopted_sigs=drv.warm_status()["warm"])
        log(f"[entry] (b) warm boot: the audit loop started "
            f"{rec['gate_s']:.3f} s after start() (the rows' load and "
            f"the prewarm), ready {rec['ready_s']:.3f} s after "
            f"Runtime(...); first sweep {rec['first_s']:.3f} s {stats}, "
            f"paths {rec['first']['paths']}, rows adopted for "
            f"{rec['rows_adopted']} of {len(kinds)} kinds, "
            f"{rec['adopted_sigs']} of {sigs} stored sweep signatures "
            f"adopted, compile counts {counts}")
        check(restores("fallback") == 0 and restores("ok") >= 4,
              f"restores: ok {restores('ok')}, fallback "
              f"{restores('fallback')}")
        check(rec["gate_s"] < RESTORE_GATE_S, f"the audit loop waited "
              f"{rec['gate_s']} s for the restore")
        check(stats.get("sweep") == "incremental" and stats.get("dirty") == 0,
              f"the warm first sweep {stats}")
        check(not pod_lists, f"the warm boot listed every Pod: {pod_lists}")
        check(drv.restored_rows_adopted == len(kinds),
              f"rows adopted for {drv.restored_rows_adopted} of "
              f"{len(kinds)} kinds")
        check(rec["first"]["paths"] == {"device": kinds},
              f"the warm first sweep's paths {rec['first']['paths']}")
        check(counts["fresh"] == 0 and counts["cache"] == 0 and
              counts["error"] == 0 and all(loaded.values()),
              f"the warm boot compiled: {counts}, aot per kind {loaded}")
        check(not serving_compiles(compiles0), f"compiles off the warm "
              f"threads: {serving_compiles(compiles0)}")
        totals = {k: v[0] for k, v in warm.items()}
        check(warm == cold and totals == ENTRY_TOTALS,
              f"the statuses after the warm first sweep differ from the "
              f"cold boot's last ones: {status_diff(cold, warm)}; totals "
              f"unlike ENTRY_TOTALS: "
              f"{ {k: v for k, v in totals.items() if v != ENTRY_TOTALS.get(k)} }")
        entry_quarantine(drv)
    finally:
        rt.stop()
    rec["launches"] = launch_counts()
    check(rec["launches"]["K2"] > 0,
          f"the warm boot launched {rec['launches']}")
    log(f"[entry] (b) the warm first sweep: all {len(kinds)} kinds on the "
        f"card with their restored rows, statuses equal to the cold "
        f"boot's; launches {rec['launches']}")
    return rec


def phase_entry(dev, report: dict) -> None:
    """Phase 17: the entry point's cold boot (entry_cold) and warm boot
    (entry_warm), each a child process of its own (`--entry MODE DIR`)
    with an empty Triton cache, on one state dir under _build/; prints
    both boots' time to ready and first sweep side by side, the first
    sweeps split by their trace phases."""
    build = os.path.join(ROOT, "gatekeeper_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="entry-", dir=build)
    state = os.path.join(work, "state")
    recs: dict = {}
    try:
        for mode in ("cold", "warm"):
            child = ChildProcess(f"entry-{mode}-", ["--entry", mode, state],
                                 triton=True)
            code, out, err, el, _left = child.wait(
                600, f"phase 17's {mode} child")
            for line in (out[:-1] if code == 0 else out):
                log(line)
            for line in err[-40:]:
                log(f"[entry] {mode} child stderr: {line}")
            check(code == 0 and out, f"phase 17's {mode} child "
                  f"{child_exit(code, err)}")
            recs[mode] = json.loads(out[-1])["entry"]
            recs[mode]["child_s"] = el
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cold, warm = recs["cold"], recs["warm"]
    for what, key in (("time to ready", "ready_s"),
                      ("first sweep", "first_s")):
        log(f"[entry] {what}: cold {cold[key]:.3f} s, warm "
            f"{warm[key]:.3f} s")
    for mode, r in recs.items():
        log(f"[entry] {mode} first sweep by trace phase: "
            + ", ".join(f"{k} {v:.3f} s"
                        for k, v in r["first"]["spans"].items()))
    report["entry"] = {
        "cold": cold, "warm": warm,
        "launches": {k: cold["launches"][k] + warm["launches"][k]
                     for k in cold["launches"]}}


# phase 18: BENCH config 13 (bench_configs.py config13) at its
# BENCH_r07 size, two audit shard children sharing the one card
PLANE_PODS = 200_000
PLANE_SHARDS = 2
# per constraint, the JAX package's unsharded audit, its 2-shard
# composed round and the round after two churn rounds alike
# (tests/torch_reference_counts.py --sharded 200000)
PLANE_COUNTS = {"K8sRequiredLabels/pods-need-team": 200,
                "K8sUniqueIngressHost/unique-hosts": 0}
# the N-engine admission plane: frontends and engines (engine 0 in the
# Runtime's process, engine 1 a child on the same card)
PLANE_WORKERS = 2
PLANE_ENGINES = 2
PLANE_RECORDS = ("plane_sharded", "plane_engines", "plane_service",
                 "plane_scan")
# the policy service: phase 8's general library at 10,000 objects
SERVICE_OBJECTS = 10_000


def card_handles(pid: int) -> bool:
    """Whether process `pid` holds the card open: a descriptor of
    /dev/nvidia<N>, which its CUDA context keeps. (In a container,
    nvidia-smi's compute-apps list may name processes by the PIDs of
    another namespace, and then it cannot tell the children apart.)"""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            if re.fullmatch(r"/dev/nvidia\d+",
                            os.readlink(f"/proc/{pid}/fd/{fd}")):
                return True
        except OSError:
            pass
    return False


def compute_apps() -> list:
    """nvidia-smi's compute-apps lines (pid, used memory)."""
    if shutil.which("nvidia-smi") is None:
        return []
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


class CardWatch:
    """While it runs (a `with` block), samples every 0.25 s which of
    `pids()` hold the card open and how many compute apps nvidia-smi
    lists."""

    def __init__(self, pids):
        self.pids = pids
        self.on_card: set = set()
        self.apps_max = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(60)

    def _run(self) -> None:
        while True:
            for pid in self.pids():
                if card_handles(pid):
                    self.on_card.add(pid)
            self.apps_max = max(self.apps_max, len(compute_apps()))
            if self._stop.wait(0.25):
                return


def relayed(name: str, engine: str) -> float | None:
    """The sum of the series of metric `name` labelled engine=`engine`
    in this process's registry (what the supervisors relay from their
    children), None without one."""
    from gatekeeper_tpu_torch.control import metrics

    pat = re.compile(r"^" + re.escape(name) + r"\{([^}]*)\} (\S+)$", re.M)
    vals = [float(v) for labels, v in pat.findall(metrics.REGISTRY.render())
            if f'engine="{engine}"' in labels.split(",")]
    return sum(vals) if vals else None


def plane_sharded(report: dict, device: str = "cuda",
                  pods: int = PLANE_PODS, want=None) -> None:
    """Phase 18 (a): BENCH config 13's sharded audit. A leader client
    holds the cluster (parallel/workload.py c13_objects: `pods` pods,
    their Namespaces, the Ingresses); an AuditShardSupervisor spawns
    PLANE_SHARDS `gatekeeper_tpu_torch.control.engine --serve
    auditslice` children on the card and syncs each its slice; a
    ShardedAuditPlane composes their sweeps. The first round (each
    child encodes its slice and compiles K2 inline), a full round after
    a slice resync (K2 warm), two rounds of config13's routed churn and
    a round after shard 1 is killed (respawn and resync) must each give
    the JAX package's per constraint counts; each child holds the card
    open while it sweeps, and the relayed duty cycle of each reads above
    0 after the warm round."""
    from gatekeeper_tpu_torch import policies
    from gatekeeper_tpu_torch.client import Backend
    from gatekeeper_tpu_torch.control.audit import ShardedAuditPlane
    from gatekeeper_tpu_torch.control.backplane import AuditShardSupervisor
    from gatekeeper_tpu_torch.control.kube import FakeKube
    from gatekeeper_tpu_torch.ir import TorchDriver
    from gatekeeper_tpu_torch.parallel.workload import (
        C13_CONSTRAINTS, REQUIRED_LABELS_TEMPLATE, c13_churn, c13_objects)
    from gatekeeper_tpu_torch.target import K8sValidationTarget

    want = PLANE_COUNTS if want is None else want
    # the shard children compile K2 inline (their first round on the
    # card, as the phases before 15 pin their drivers)
    os.environ["GATEKEEPER_TPU_ASYNC_COMPILE"] = "0"
    leader = Backend(TorchDriver(device=device)).new_client(
        [K8sValidationTarget()])
    leader.add_template(REQUIRED_LABELS_TEMPLATE)
    leader.add_template(policies.load("general/uniqueingresshost"))
    for c in C13_CONSTRAINTS:
        leader.add_constraint(c)
    t0 = time.perf_counter()
    objs = c13_objects(pods)
    for o in objs:
        leader.add_data(o)
    ingest = time.perf_counter() - t0
    n_objects = len(objs)
    del objs
    settle()
    tmp = tempfile.mkdtemp(prefix="gk-plane-")
    box: list = []
    sup = AuditShardSupervisor(
        PLANE_SHARDS, socket_for=lambda k: os.path.join(tmp, f"audit.{k}"),
        spawn_args=["--log-level", "WARNING"]
        + ([] if device == "cuda" else ["--device", device]),
        snapshot_provider=lambda k: box[0].sync_snapshot(k))
    plane = ShardedAuditPlane(FakeKube(), leader, sup, PLANE_SHARDS)
    box.append(plane)
    rec: dict = {"objects": n_objects, "leader_ingest_s": ingest}
    rounds: dict = {}

    def sweep(what: str) -> None:
        with CardWatch(lambda: list(sup.child_pids().values())) as watch:
            t0 = time.perf_counter()
            res, stats = plane.sweep(None)
            wall = time.perf_counter() - t0
        pids = list(sup.child_pids().values())  # a respawned one's too
        got = dict.fromkeys(want, 0)
        got.update({f"{k}/{n}": len(run)
                    for (k, n), run in per_constraint(res).items()})
        check(got == want, f"sharded audit, {what} round: {got}, want "
              f"{want} (the JAX package's)")
        if device == "cuda":
            check(set(pids) <= watch.on_card, f"sharded audit, {what} "
                  f"round: shard children {pids} never held the card "
                  f"open while sweeping (seen {sorted(watch.on_card)})")
        rounds[what] = {"s": wall, "results": len(res),
                        "shard_eval_max_s": stats["shard_eval_max_s"],
                        "compute_apps_max": watch.apps_max}
        log(f"[plane] sharded audit, {what} round: {wall:.3f} s, {got} "
            f"(equal to the JAX package's); slowest shard's sweep "
            f"{stats['shard_eval_max_s']:.3f} s; children {pids} on the "
            f"card; nvidia-smi lists up to {watch.apps_max} compute apps")

    try:
        t0 = time.perf_counter()
        sup.start()
        rec["spawn_sync_s"] = time.perf_counter() - t0
        log(f"[plane] sharded audit: {rec['objects']} objects, leader "
            f"ingest {ingest:.1f} s; {PLANE_SHARDS} shard children "
            f"spawned and their slices synced in {rec['spawn_sync_s']:.3f} "
            "s")
        sweep("first")
        for k in range(PLANE_SHARDS):
            sup._resync(k)  # a full round again, K2 warm in each child
        sweep("warm")
        duty: dict = {}

        def relayed_duty() -> bool:
            for k in range(PLANE_SHARDS):
                duty[k] = relayed("gatekeeper_tpu_device_duty_cycle",
                                  f"audit{k}")
            return all((v or 0) > 0 for v in duty.values())

        wait_for(relayed_duty, 15.0, "sharded audit: the relayed duty "
                 f"cycle did not read above 0 ({duty})")
        rec["duty_cycle"] = dict(duty)
        log(f"[plane] sharded audit: relayed duty cycle after the warm "
            f"round {duty}")
        # config13's steady state: churn routed owner-only to the
        # shards, which re-evaluate their dirty rows
        plane.attach()
        for r in range(2):
            for pod in c13_churn(pods, r):
                leader.add_data(pod)
            sweep(f"churn {r + 1}")
        gen = dict(sup.generation)
        sup.kill_engine(1)
        sweep("after a shard kill")
        check(sup.generation[1] > gen[1] and
              sup.alive_count() == PLANE_SHARDS,
              f"sharded audit: shard 1 not respawned and resynced "
              f"(generations {gen} -> {sup.generation})")
    finally:
        sup.stop()
        plane.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    rec["rounds"] = rounds
    report["plane_sharded"] = rec


def plane_engines(report: dict, device: str = "cuda", n: int = 512,
                  corpus_n: int = 2000) -> None:
    """Phase 18 (b): the N-engine admission plane. A Runtime with
    --operation webhook, --admission-workers 2 and --admission-engines 2
    (engine 1 a child on the same card) and phase 9's library and
    corpus added through its client, which replicates them to the
    child; phase 9b's `n` manifests as AdmissionReviews from phase 9b's
    load generator through the frontends, engine 1 SIGKILLed
    mid-burst: every response answered and byte-equal to the
    interpreter's verdict, both engines' requests in the relayed
    gatekeeper_tpu_engine_requests_total, the victim respawned and
    resynced."""
    from gatekeeper_tpu_torch.client import RegoDriver
    from gatekeeper_tpu_torch.control.main import Runtime, build_parser

    os.environ.pop("GATEKEEPER_TPU_ASYNC_COMPILE", None)  # the default
    oracle = library_client(RegoDriver(), compiled_only=False)
    inventory = corpus(corpus_n)
    for o in inventory:
        oracle.add_data(o)
    objs = corpus(n)
    pairs = [[(r.enforcement_action, r.msg) for r in resp.results()]
             for resp in oracle.review_batch(objs)]
    del oracle
    tmp = tempfile.mkdtemp(prefix="gk-plane-")
    args = build_parser().parse_args([
        "--fake-kube", "--operation", "webhook", "--admission-workers",
        str(PLANE_WORKERS), "--admission-engines", str(PLANE_ENGINES),
        "--port", "0", "--health-addr", ":0", "--prometheus-port", "0",
        "--disable-cert-rotation", "--device", device,
        "--backplane-socket", os.path.join(tmp, "bp.sock")])
    t0 = time.perf_counter()
    rt = Runtime(args)
    rt.args.metrics_backend = "none"
    rt.start()
    rec: dict = {"start_s": time.perf_counter() - t0}
    try:
        check(rt.engines is not None and rt.engines.alive_count() == 1,
              "admission plane: engine 1 is not running")
        t0 = time.perf_counter()
        add_library(rt.opa, compiled_only=False)
        for o in inventory:
            rt.opa.add_data(o)
        rec["replicate_s"] = time.perf_counter() - t0
        check(not any(rt.engines._dirty.values()),
              "admission plane: the library did not replicate to engine 1")
        evaluated = [0]
        evaluate = rt.validation_handler.batcher._evaluate

        def counted(reviews):
            evaluated[0] += len(reviews)
            return evaluate(reviews)

        rt.validation_handler.batcher._evaluate = counted
        killed: list = []

        def killer(t_start: float) -> None:
            # mid-burst: once engine 0 has evaluated an eighth of the
            # burst and engine 1's requests have been relayed (a poll
            # just before the kill: a dead child's counts are lost), or
            # 5 s in
            while time.perf_counter() - t_start < 5:
                if evaluated[0] >= n // 8:
                    rt.engines.poll_stats()
                    if (relayed("gatekeeper_tpu_engine_requests_total",
                                "1") or 0) > 0:
                        break
                time.sleep(0.005)
            rt.engines.kill_engine(1)
            killed.append((evaluated[0], time.perf_counter() - t_start))

        uids, bodies, want = admission_bodies("plane", objs, pairs)
        kill = threading.Thread(target=killer, args=(time.perf_counter(),),
                                daemon=True)
        kill.start()
        out = run_loadgen(rt.frontends.port, bodies)
        kill.join(30)
        bad = [(u, r, w) for u, r, w in zip(uids, out["results"], want)
               if r is None or r[0] != 200 or r[1] != w]
        check(not bad, f"admission plane: {len(bad)} of {n} responses "
              f"unanswered or unlike the interpreter's; first {bad[0][0]}: "
              f"got {bad[0][1]!r:.600} want {bad[0][2]!r:.600}"
              if bad else "")
        check(bool(killed), "admission plane: engine 1 was not killed")
        wait_for(lambda: rt.engines.alive_count() == 1
                 and not rt.engines._dirty.get(1), 120.0,
                 "admission plane: engine 1 not respawned and resynced")
        rt.engines.poll_stats()
        per_engine = {e: relayed("gatekeeper_tpu_engine_requests_total", e)
                      for e in ("0", "1")}
        check(all((v or 0) > 0 for v in per_engine.values()),
              f"admission plane: requests per engine {per_engine}")
        lat = [r[2] for r in out["results"]]
        rec.update({"p50_ms": percentile(lat, 0.50) * 1e3,
                    "p99_ms": percentile(lat, 0.99) * 1e3,
                    "max_ms": max(lat) * 1e3,
                    "rps": len(lat) / out["wall_s"],
                    "engine_requests": per_engine,
                    "killed_after": {"engine0_reviews": killed[0][0],
                                     "s": killed[0][1]}})
        log(f"[plane] admission plane ({PLANE_WORKERS} frontends, "
            f"{PLANE_ENGINES} engines): {n} AdmissionReviews answered and "
            f"equal to the interpreter with engine 1 killed "
            f"{killed[0][1]:.3f} s in; p50 {rec['p50_ms']:.3f} ms, p99 "
            f"{rec['p99_ms']:.3f} ms, {rec['rps']:.1f} requests/s; "
            f"requests per engine {per_engine}; the victim respawned and "
            "resynced")
    finally:
        rt.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    report["plane_engines"] = rec


def plane_service(report: dict, device: str = "cuda",
                  n: int = SERVICE_OBJECTS, want: int | None = None,
                  batch: int = 512) -> None:
    """Phase 18 (c): the gRPC policy service in this process
    (make_server on `device`, its driver compiling inline) and a
    RemoteClient against it: phase 8's general library and its `n`
    objects sent over the wire, then audit() must give the JAX
    package's count (332 at 10,000) and the `batch` corpus manifests'
    review batch the interpreter's results over the same library and
    objects; K2 and K1 must launch."""
    from gatekeeper_tpu_torch import policies
    from gatekeeper_tpu_torch.client import RegoDriver
    from gatekeeper_tpu_torch.parallel.workload import (
        GENERAL_CONSTRAINTS, synth_mixed_objects)
    from gatekeeper_tpu_torch.service import RemoteClient, make_server

    want = GENERAL_RESULTS[n] if want is None else want
    os.environ["GATEKEEPER_TPU_ASYNC_COMPILE"] = "0"
    objs = synth_mixed_objects(n)
    manifests = corpus(batch)
    oracle = general_client(RegoDriver())
    for o in objs:
        oracle.add_data(o)
    want_batch = [result_key(r.results())
                  for r in oracle.review_batch(manifests)]
    del oracle
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    server, port = make_server(address="127.0.0.1:0", device=device)
    server.start()
    rc = RemoteClient(f"127.0.0.1:{port}")
    rec: dict = {}
    try:
        t0 = time.perf_counter()
        for name in policies.names():
            if name.startswith("general/"):
                rc.add_template(policies.load(name))
        for c in GENERAL_CONSTRAINTS:
            rc.add_constraint(library_constraint(*c))
        for o in objs:
            rc.add_data(o)
        rec["ingest_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = rc.audit().results()
        rec["audit_s"] = time.perf_counter() - t0
        check(len(res) == want, f"policy service: audit() of {n} objects "
              f"returned {len(res)} results, want {want}")
        t0 = time.perf_counter()
        got = [result_key(r.results()) for r in rc.review_batch(manifests)]
        rec["review_batch_s"] = time.perf_counter() - t0
        check(got == want_batch, f"policy service: the review batch of "
              f"{batch} differs from the interpreter")
    finally:
        rc.close()
        server.stop(grace=2.0)
    rec["launches"] = {k: w.launches for k, w in wrappers.items()}
    if device == "cuda":
        check(rec["launches"]["K1"] > 0 and rec["launches"]["K2"] > 0,
              f"policy service: K1 or K2 never launched "
              f"({rec['launches']})")
    import grpc

    log(f"[plane] policy service (gRPC, grpc {grpc.__version__}): {n} "
        f"objects sent in {rec['ingest_s']:.1f} s; audit() "
        f"{rec['audit_s']:.3f} s, "
        f"{len(res)} results (the JAX package's {want}); review batch of "
        f"{batch} {rec['review_batch_s']:.3f} s, equal to the interpreter; "
        f"launches {rec['launches']}")
    report["plane_service"] = rec


# phase 19: BENCH config 16 (bench_configs.py config16), the offline fleet
# scan, cut from BENCH_r07's 1,000,000 manifests to 50,000 (6,250 unique
# synth_mixed_objects x 8, its shuffle and seed kept): at 100,000 the
# phase took 162.3 s alone, over its 150 s
SCAN_MANIFESTS = 50_000
# the JAX package's scan_main over the same export
# (tests/torch_reference_counts.py --scan N): the export's sha256, the
# summary's counts and the records' digest (scan_digest)
SCAN_REFERENCE = {
    100_000: {
        "jsonl_sha256": "14bc2157004e75ca456cb3c826b33e80"
                        "f3238ee4e20228a0aa94d24f3d608712",
        "summary": {"manifests": 100000, "unique_evaluated": 12500,
                    "deduped": 87500, "allowed": 12341, "denied": 1272,
                    "errors": 0, "skipped_docs": 0},
        "records_sha256": "910a0d8d72dc244c7605187fc06159716987ac8ab15e24"
                          "b715f0c4bb298cd32c"},
    50_000: {
        "jsonl_sha256": "3ab9941e39c8a0f44950270843d9b0e98474e474cdcc9b"
                        "2b336ccad24ba63fa0",
        "summary": {"manifests": 50000, "unique_evaluated": 6250,
                    "deduped": 43750, "allowed": 6176, "denied": 592,
                    "errors": 0, "skipped_docs": 0},
        "records_sha256": "cb1457fd7fca87e0e15ebf87ef6f4944869a008a98af97"
                          "e46abe956d03fa269c"},
}
# config16's pipeline settings (2 loaders: the card's machine has 8 cores
# and the smoke's other processes share them)
SCAN_FLAGS = ["--loaders", "2", "--batch", "256", "--depth", "2",
              "--dedupe", "65536"]
SCAN_TIMEOUT_S = 300


@contextlib.contextmanager
def drivers_built():
    """The TorchDrivers constructed inside the block, in order (the ones
    an entry point builds for itself: the scan's in-process engine, the
    policy service's)."""
    from gatekeeper_tpu_torch.ir import TorchDriver

    built: list = []
    init = TorchDriver.__init__

    def recording(self, *a, **kw):
        init(self, *a, **kw)
        built.append(self)

    TorchDriver.__init__ = recording
    try:
        yield built
    finally:
        TorchDriver.__init__ = init


def quarantines(drv) -> dict:
    """The kinds `drv` has benched or benched and restored, with their
    reasons."""
    out = {k: v["reason"] for k, v in drv.quarantine_status().items()}
    out.update((k, "restored") for k in drv._quarantine_hist
               if k not in out)
    return out


def scan_run(mode: str, cfg_path: str) -> dict:
    """Phase 19's children on the card (`--scan-run MODE CFG`; CFG a JSON
    file of paths and flags), each counting its own launches from 0:
    cli, (a): `main(["scan", ...])`, control/main.py's entry point as
    `python -m gatekeeper_tpu_torch.control.main scan` runs it, on its
    default device with the cost model deciding; cold, (b), and warm,
    (c): the functions scan_main calls (ingest_policies,
    build_inproc_tier(client=...), LoaderPool, run_scan) on a
    TorchDriver(aot_dir=CFG's store) whose batch path is pinned to the
    device (_use_device_for_batch, as phase 9b's pinned passes pin it),
    with async warm on (the package default), in CFG's Triton cache:
    cold serves a batch whose K2 variant is not warm yet from the host
    while a warm thread compiles it, and waits for those compiles before
    it exits, so that the store keeps every variant; warm waits for the
    prewarm to load the stored variants before it scans. Returns the
    exit code, the summary, per kind the path taken, the launches, the
    program store's counts and the compiles off the warm threads."""
    from gatekeeper_tpu_torch.ir import aot
    from gatekeeper_tpu_torch.kernels import build as kernel_build

    with open(cfg_path) as f:
        cfg = json.load(f)
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    counts0 = dict(aot.COMPILE_COUNTS)
    compiles0 = kernel_build.compiles_by_thread()
    rec: dict = {}
    if mode == "cli":
        from gatekeeper_tpu_torch.control.main import main as entry

        # --compile-cache-dir sets Triton's cache only where none is set
        os.environ.pop("TRITON_CACHE_DIR", None)
        with drivers_built() as built:
            rec["exit"] = entry(["scan"] + cfg["argv"])
        with open(cfg["summary"]) as f:
            rec["summary"] = json.load(f)
        (drv,) = built
        rec["triton_cache"] = os.environ.get("TRITON_CACHE_DIR")
    else:
        from gatekeeper_tpu_torch.client import Backend
        from gatekeeper_tpu_torch.control import scan
        from gatekeeper_tpu_torch.ir import TorchDriver
        from gatekeeper_tpu_torch.target import K8sValidationTarget

        os.environ["TRITON_CACHE_DIR"] = cfg["triton"]
        drv = TorchDriver(device=cfg["device"], aot_dir=cfg["aot_dir"])
        check(drv.aot.enabled and drv.async_warm, "scan: the program "
              "store is disabled or async warm is off")
        drv._use_device_for_batch = lambda n: True
        client = Backend(drv).new_client([K8sValidationTarget()])
        scan.ingest_policies(client, cfg["policies"])
        if mode == "warm":
            stored = drv.aot.programs_count()
            # (no K2 compiles on the CPU, so nothing is stored there)
            check(stored > 0 or cfg["device"] != "cuda", f"scan, warm: "
                  f"the program store at "
                  f"{cfg['aot_dir']} holds no program")
            t1 = time.perf_counter()
            check(drv.wait_prewarm(120), "scan, warm: the prewarm did not "
                  "finish in 120 s")
            rec.update(stored=stored, prewarm_s=time.perf_counter() - t1)
        tier = scan.build_inproc_tier([], client=client,
                                      timeout_s=SCAN_TIMEOUT_S)
        loader = scan.LoaderPool("jsonl", [cfg["jsonl"]], 2,
                                 encode=tier.wants_bytes)
        try:
            with open(cfg["output"], "w") as out:
                rec["summary"] = scan.run_scan(
                    tier, loader, out, batch_size=256, depth=2,
                    dedupe_size=65536)
        finally:
            tier.close()
        rec["exit"] = scan.exit_code(rec["summary"])
        # a warm the scan started still running at exit would take the
        # process down with it (and the cold store would lack its variant)
        rec["drain_s"] = wait_warm(drv, 300)
    rec["paths"] = kind_paths(drv, {})
    rec["launches"] = {k: w.launches for k, w in wrappers.items()}
    rec["counts"] = {k: aot.COMPILE_COUNTS[k] - counts0.get(k, 0)
                     for k in aot.COMPILE_COUNTS}
    rec["sources"] = (
        {k: sorted({ev["source"] for ev in drv.aot.events_for(k)})
         for k in sorted(drv._programs)} if drv.aot.enabled else {})
    rec["serving_compiles"] = serving_compiles(compiles0)
    rec["quarantined"] = quarantines(drv)
    return rec


def scan_verdicts(what: str, rc: int, summary: dict, out_path: str,
                  want: dict) -> str:
    """Hold one run to the JAX package's scan of the same export: exit
    code 1 with no error record, its counts, and its records' digest;
    returns the digest."""
    from gatekeeper_tpu_torch.parallel.workload import scan_digest

    with open(out_path) as f:
        digest = scan_digest(json.loads(line) for line in f)
    got = {k: summary.get(k) for k in want["summary"]}
    check(rc == 1 and summary.get("errors") == 0, f"scan, {what}: exit "
          f"code {rc} with {summary.get('errors')} error records, want 1 "
          "and 0")
    check(got == want["summary"], f"scan, {what}: {got}, want "
          f"{want['summary']} (the JAX package's)")
    check(digest == want["records_sha256"], f"scan, {what}: the records' "
          f"digest {digest} differs from the JAX package's "
          f"{want['records_sha256']}")
    return digest


def scan_cli(argv: list, timeout: float) -> tuple:
    """`python -m gatekeeper_tpu_torch.control.main scan ARGV` in a child
    process that sees no card (CUDA_VISIBLE_DEVICES empty: the
    cross-process tiers evaluate in the server); (exit code, seconds,
    stderr's last lines)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gatekeeper_tpu_torch.control.main", "scan",
         *argv], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=timeout)
    return proc.returncode, time.perf_counter() - t0, \
        proc.stderr.strip().splitlines()[-3:]


def plane_scan(report: dict, device: str = "cuda", n: int = SCAN_MANIFESTS,
               want: dict | None = None) -> None:
    """Phase 19: BENCH config 16's offline fleet scan at `n` manifests
    (the export written by the port's parallel/workload.py c16_jsonl,
    its sha256 the JAX package's; the general library's templates and
    GENERAL_CONSTRAINTS as a policy dir), in five runs: (a) the entry
    point as a CI job runs it, in a child on its default device with a
    program store D1 and a Triton cache C1 (the cost model decides);
    (b) cold and (c) warm, each a child pinned to the device on store
    D2 and cache C2 (scan_run); (d) the backplane tier, a BackplaneEngine
    on the card in this process (the general library, no inventory,
    the cost model deciding) and `scan --backplane` in a child that sees
    no card; (e) the gRPC tier, make_server on the card with the same
    library sent through a RemoteClient and `scan --grpc` likewise.
    Every run: exit code 1, no error record, the JAX package's counts
    and record digest, no kind quarantined. (b) and (c) launch K2; (b)
    compiles ("fresh"), (c) loads every kind (b) ran on the card from
    the store ("aot") with no fresh compile and none off the warm
    threads."""
    from gatekeeper_tpu_torch.control.backplane import BackplaneEngine
    from gatekeeper_tpu_torch.control.webhook import (
        MicroBatcher, NamespaceLabelHandler, ValidationHandler)
    from gatekeeper_tpu_torch.ir import TorchDriver
    from gatekeeper_tpu_torch.parallel.workload import (
        GENERAL_CONSTRAINTS, c16_constraints_yaml, c16_jsonl)
    from gatekeeper_tpu_torch import policies
    from gatekeeper_tpu_torch.service import RemoteClient, make_server
    from gatekeeper_tpu_torch.service import server as server_mod

    want = SCAN_REFERENCE[n] if want is None else want
    build = os.path.join(ROOT, "gatekeeper_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="gk-scan-", dir=build)
    rec: dict = {"manifests": n}
    runs: dict = {}
    try:
        jsonl = os.path.join(work, "inventory.jsonl")
        t0 = time.perf_counter()
        c16_jsonl(jsonl, n)
        with open(jsonl, "rb") as f:
            sha = hashlib.sha256(f.read()).hexdigest()
        rec["write_s"] = time.perf_counter() - t0
        check(sha == want["jsonl_sha256"], f"scan: the export's sha256 "
              f"{sha} is not the JAX package's {want['jsonl_sha256']}")
        constraints = os.path.join(work, "constraints.yaml")
        c16_constraints_yaml(constraints)
        pols = [os.path.join(ROOT, "gatekeeper_tpu_torch", "policies",
                             "general"), constraints]
        dev_flags = [] if device == "cuda" else ["--device", device]

        def paths_of(what: str):
            return {k: os.path.join(work, f"{what}.{k}")
                    for k in ("out", "summary", "cfg")}

        def child_run(what: str, mode: str, cfg: dict) -> dict:
            p = paths_of(what)
            cfg = {**cfg, "output": p["out"], "summary": p["summary"]}
            with open(p["cfg"], "w") as f:
                json.dump(cfg, f)
            child = ChildProcess(f"scan-{what}-", ["--scan-run", mode,
                                                   p["cfg"]])
            code, out, err, el, _left = child.wait(SCAN_TIMEOUT_S,
                                                   f"the scan's {what} child")
            for line in err[-20:]:
                log(f"[plane] scan {what} child stderr: {line}")
            check(code == 0 and out, f"the scan's {what} child "
                  f"{child_exit(code, err)}")
            got = json.loads(out[-1])["scan_run"]
            got["child_s"] = el
            got["digest"] = scan_verdicts(what, got["exit"], got["summary"],
                                          p["out"], want)
            check(not got["quarantined"], f"scan, {what}: quarantined "
                  f"{got['quarantined']}")
            return got

        def held(what: str, r: dict) -> None:
            s = r["summary"]
            log(f"[plane] scan, {what}: {s['manifests']} manifests "
                f"({s['unique_evaluated']} evaluated, {s['deduped']} "
                f"deduped, {s['denied']} denied, 0 errors: the JAX "
                f"package's counts and record digest) in {s['wall_s']} s, "
                f"{s['manifests_per_sec']} manifests/s; child "
                f"{r.get('child_s', 0.0):.1f} s; paths {r.get('paths')}; "
                f"launches {r.get('launches')}; store {r.get('counts')}")

        # (a) as a CI job runs it: the entry point on its default device
        p = paths_of("cli")
        argv = [jsonl, "--format", "jsonl", "--policies", pols[0],
                "--policies", pols[1], "--aot-dir",
                os.path.join(work, "d1"), "--compile-cache-dir",
                os.path.join(work, "c1"), "--output", p["out"],
                "--summary", p["summary"], *SCAN_FLAGS, *dev_flags]
        runs["cli"] = child_run("cli", "cli", {"argv": argv})
        check(runs["cli"]["triton_cache"] == os.path.join(work, "c1"),
              f"scan, cli: --compile-cache-dir did not set Triton's cache "
              f"({runs['cli']['triton_cache']})")
        held("(a) as a CI job runs it (the cost model decides)",
             runs["cli"])
        # (b) cold and (c) warm, pinned to the device, on one store
        pinned = {"jsonl": jsonl, "policies": pols, "device": device,
                  "aot_dir": os.path.join(work, "d2"),
                  "triton": os.path.join(work, "c2")}
        runs["cold"] = cold = child_run("cold", "cold", pinned)
        held("(b) cold, pinned", cold)
        runs["warm"] = warm = child_run("warm", "warm", pinned)
        held("(c) warm, pinned", warm)
        if device == "cuda":
            # the kinds with a K2 program (the joins take the host probe)
            compiled = sorted({k for p, ks in cold["paths"].items()
                               if p != "join" for k in ks})
            check(cold["launches"]["K2"] > 0 and warm["launches"]["K2"] > 0,
                  f"scan: K2 did not launch pinned (cold "
                  f"{cold['launches']}, warm {warm['launches']})")
            check(compiled and cold["counts"]["error"] == 0 and
                  all("fresh" in cold["sources"].get(k, ()) for k in compiled),
                  f"scan, cold: a compiled kind {compiled} without a fresh "
                  f"compile ({cold['sources']}, {cold['counts']})")
            check(warm["paths"].get("device") == compiled and
                  warm["counts"]["fresh"] == 0 and
                  warm["counts"]["error"] == 0 and
                  all("aot" in warm["sources"].get(k, ()) for k in compiled),
                  f"scan, warm: paths {warm['paths']}, store counts "
                  f"{warm['counts']}, sources per kind {warm['sources']}")
            check(not warm["serving_compiles"], f"scan, warm: compiles off "
                  f"the warm threads {warm['serving_compiles']}")
        rec["cold_to_warm"] = (cold["summary"]["wall_s"] /
                               warm["summary"]["wall_s"])
        log(f"[plane] scan: cold to warm {rec['cold_to_warm']:.2f}x "
            f"({cold['summary']['wall_s']} s -> {warm['summary']['wall_s']} "
            f"s; the warm child loaded {warm.get('stored')} stored programs "
            f"in {warm.get('prewarm_s', 0.0):.1f} s)")
        # (d) the backplane tier: the engine in this process, on the card
        wrappers = kernel_wrappers()
        os.environ.pop("GATEKEEPER_TPU_ASYNC_COMPILE", None)  # a server's
        for w in wrappers.values():
            w.launches = 0
        drv = TorchDriver(device=device)
        client = general_client(drv)
        batcher = MicroBatcher(client, max_wait=0.003, max_batch=256)
        validation = ValidationHandler(client, kube=None, batcher=batcher,
                                       decision_cache_size=4096)
        sock = os.path.join(work, "engine.sock")
        engine = BackplaneEngine(sock, validation=validation,
                                 ns_label=NamespaceLabelHandler(()))
        engine.start()
        p = paths_of("backplane")
        try:
            code, el, tail = scan_cli(
                [jsonl, "--format", "jsonl", "--backplane", sock,
                 "--output", p["out"], "--summary", p["summary"],
                 *SCAN_FLAGS], SCAN_TIMEOUT_S)
        finally:
            engine.stop()
            batcher.stop()
        check(os.path.exists(p["summary"]), f"scan, backplane: the child "
              f"exited {code} with no summary: {tail}")
        with open(p["summary"]) as f:
            runs["backplane"] = r = {"exit": code, "child_s": el,
                                     "summary": json.load(f)}
        r["digest"] = scan_verdicts("backplane", code, r["summary"],
                                    p["out"], want)
        r["paths"] = kind_paths(drv, {})
        r["launches"] = {k: w.launches for k, w in wrappers.items()}
        check(not quarantines(drv), f"scan, backplane: quarantined "
              f"{quarantines(drv)}")
        held("(d) the backplane tier (the engine on the card, the cost "
             "model deciding)", r)
        del engine, validation, batcher, client, drv
        # (e) the gRPC tier: the policy service on the card
        for w in wrappers.values():
            w.launches = 0
        with drivers_built() as built:
            server, port = make_server(address="127.0.0.1:0", device=device)
        server.start()
        rc = RemoteClient(f"127.0.0.1:{port}")
        p = paths_of("grpc")
        try:
            for name in policies.names():
                if name.startswith("general/"):
                    rc.add_template(policies.load(name))
            for c in GENERAL_CONSTRAINTS:
                rc.add_constraint(library_constraint(*c))
            code, el, tail = scan_cli(
                [jsonl, "--format", "jsonl", "--grpc", f"127.0.0.1:{port}",
                 "--output", p["out"], "--summary", p["summary"],
                 *SCAN_FLAGS], SCAN_TIMEOUT_S)
        finally:
            rc.close()
            server.stop(grace=2.0)
        check(os.path.exists(p["summary"]), f"scan, grpc: the child "
              f"exited {code} with no summary: {tail}")
        with open(p["summary"]) as f:
            runs["grpc"] = r = {"exit": code, "child_s": el,
                                "summary": json.load(f)}
        r["digest"] = scan_verdicts("grpc", code, r["summary"], p["out"],
                                    want)
        (drv,) = built
        r["paths"] = kind_paths(drv, {})
        r["launches"] = {k: w.launches for k, w in wrappers.items()}
        check(not quarantines(drv), f"scan, grpc: quarantined "
              f"{quarantines(drv)}")
        held("(e) the gRPC tier (the policy service on the card)", r)
        del server, rc, drv, built
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec["runs"] = {k: {"s": r["summary"]["wall_s"],
                       "manifests_per_sec": r["summary"]["manifests_per_sec"],
                       "child_s": r["child_s"], "paths": r["paths"],
                       "launches": r["launches"],
                       **({"counts": r["counts"]} if "counts" in r else {})}
                   for k, r in runs.items()}
    rec["launches"] = {k: sum(r["launches"][k] for r in runs.values())
                       for k in kernel_wrappers()}
    report["plane_scan"] = rec


# phase 20: the audit mesh over virtual shards of the one card. Config 4
# swept over MESH_DATA shards (4: one dispatch per shard, n_loc 32,768;
# 2: the slab loop, n_loc 65,536 = 8 slabs of 8,192); make_audit_step
# over MESH_STEP (data x model) shards; the sharded join over 8
MESH_DATA = (4, 2)
MESH_STEP = (4, 2)
MESH_JOIN = 8
MESH_BUCKET = 131_072   # config 4's extraction bucket
MESH_REPLACED = 500     # Namespaces replaced for K5's mesh half
# K6 against its plain version: (rows, W, density, r_begin, r_end, c, C)
# beside config 4's shard words; c not a multiple of 32, r_begin > 0,
# r_end < rows, and W past one block's 32 words
K6_RAGGED = ((1000, 2, 0.1, 7, 993, 45, 64), (4099, 3, 0.02, 1, 4000, 70, 70),
             (300, 40, 0.05, 0, 300, 1270, 1280),
             (700, 3, 0.2, 0, 0, 70, 70), (513, 2, 0.2, 0, 513, 50, 50))
# K6 into strided destinations: (rows, W, c, row stride, column offset),
# a shard's block of a wider fires (row stride above c_loc, a column
# offset not a multiple of 16)
K6_STRIDED = ((1000, 2, 45, 64, 19), (3001, 8, 250, 500, 250),
              (777, 40, 1270, 1301, 7))


def mesh_resident(drv, dev) -> int:
    """Every shard's resident feature rows equal the host array's rows of
    that shard, byte for byte. Returns the number of blocks checked."""
    import torch

    from gatekeeper_tpu_torch.ir.carry import to_tensor

    data = drv._mesh.shape["data"]
    n = 0
    for kind, fc in drv._feat_cache.items():
        for arrs in fc["__meta__"]["feats"].values():
            for a in arrs.values():
                ent = drv._dev_mesh_cache.get((id(a), True))
                check(ent is not None and ent[0]() is a,
                      f"{kind}: a feature leaf is not resident on the mesh")
                n_loc = a.shape[0] // data
                for d in range(data):
                    fresh = to_tensor(a[d * n_loc:(d + 1) * n_loc], dev)
                    check(torch.equal(ent[1].block(d).view(torch.uint8),
                                      fresh.view(torch.uint8)),
                          f"{kind}: shard {d}'s resident rows differ from "
                          "the host array's")
                    n += 1
    return n


def mesh_replacements(n: int) -> list:
    """MESH_REPLACED of config 4's n Namespaces, spread over every shard,
    each with the labels of its successor, and every fifth with one label
    broken as synth_objects breaks them: values from the vocabulary, the
    same label count bound (K5 patches them)."""
    from gatekeeper_tpu_torch.parallel.workload import synth_objects

    objs = synth_objects(n, violate_frac=0.01, seed=0)
    step = n // MESH_REPLACED
    out = []
    for k in range(MESH_REPLACED):
        i = k * step + step // 2
        labels = dict(objs[i + 1]["metadata"]["labels"])
        if k % 5 == 0 and labels:
            labels[sorted(labels)[0]] = "###BAD###"
        out.append({"apiVersion": "v1", "kind": "Namespace",
                    "metadata": {"name": objs[i]["metadata"]["name"],
                                 "labels": labels}})
    return out


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def mesh_audits(rec: dict, dev, n: int) -> None:
    """Phase 20 (b)-(d): config 4 at n objects on one device, then over
    each MESH_DATA width of virtual shards of `dev`, results equal in
    order; then MESH_REPLACED replacements, re-swept in the last mesh
    driver and the single one."""
    from gatekeeper_tpu_torch.ir import evaltorch
    from gatekeeper_tpu_torch.ir.features import _bucket
    from gatekeeper_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    # the drivers take the device type: a device with an index pins a
    # driver to that one card, which then takes no mesh
    single = foreground_driver(device=dev.type)
    cs = flagship(single, n)
    t1 = time.perf_counter()
    want = result_key(cs.audit().results())
    rec["single_s"] = time.perf_counter() - t1
    check(single.last_audit_path == f"single({dev.type})" and
          (n != CONFIG4[0] or len(want) == CONFIG4_RESULTS),
          f"the single-device config-4 audit: {single.last_audit_path}, "
          f"{len(want)} results")
    log(f"[mesh] config 4 ({n} objects) on one device: ingest "
        f"{t1 - t0:.1f} s, first audit {rec['single_s']:.3f} s, "
        f"{len(want)} results")
    for data in MESH_DATA:
        drv = foreground_driver(mesh=make_mesh([dev] * data),
                                device=dev.type)
        client = flagship(drv, n)
        handles = []
        dispatch = drv._dispatch_handle

        def spy(*a, **k):
            handles.append(dispatch(*a, **k))
            return handles[-1]

        drv._dispatch_handle = spy
        t1 = time.perf_counter()
        got = result_key(client.audit().results())
        el = time.perf_counter() - t1
        drv._dispatch_handle = dispatch
        ct = drv.compiled_for("K8sRequiredLabels")
        rows = _bucket(n)
        lslab = ct._mesh_plan(rows, data, drv.sweep_chunk,
                              drv.mesh_slab_local)[2]
        slabbed = [isinstance(h, evaltorch._MeshSlabPairs) for h in handles]
        part = "b" if data == MESH_DATA[0] else "c"
        check(drv.last_audit_path == f"mesh(data={data})",
              f"({part}) config 4 over {data} shards took path "
              f"{drv.last_audit_path} (mesh {drv._mesh}, quarantined "
              f"{drv.quarantine_status()})")
        check(slabbed == [lslab is not None] and
              (n != CONFIG4[0] or (rows == MESH_BUCKET and
                                   (lslab is not None) == (data == 2))),
              f"({part}) bucket {rows}, local slab {lslab}, handles "
              f"slabbed {slabbed}")
        check(got == want, f"({part}) the mesh(data={data}) results differ "
              f"from the single-device driver's ({len(got)} against "
              f"{len(want)}, order included)")
        rec[f"data{data}_s"] = el
        how = (f"the slab loop, {rows // data // lslab} slabs of {lslab}"
               if lslab else "one dispatch a shard")
        log(f"[mesh] ({part}) config 4 over {data} virtual shards: {how}, "
            f"n_loc {rows // data}, first audit {el:.3f} s, {len(got)} "
            f"results equal to one device's in order; pair capacity a "
            f"shard {ct._rows_cap_mesh}")
        mesh_drv, mesh_client = drv, client
        del client, drv
    # (d) K5's mesh half: replacements patched into each shard's rows,
    # the kinds re-swept (the delta cache dropped) in both drivers
    wrappers = kernel_wrappers()
    k5_before = wrappers["K5"].launches
    for client in (mesh_client, cs):
        for o in mesh_replacements(n):
            client.add_data(o)
    got = []
    for drv, client in ((mesh_drv, mesh_client), (single, cs)):
        drv._audit_results_cache.clear()
        got.append(result_key(client.audit().results()))
    k5 = wrappers["K5"].launches - k5_before
    check(mesh_drv.last_audit_path == f"mesh(data={MESH_DATA[-1]})" and
          single.last_audit_path == f"single({dev.type})",
          f"(d) paths {mesh_drv.last_audit_path}, {single.last_audit_path}")
    check(got[0] == got[1] and got[0] != want,
          f"(d) after {MESH_REPLACED} replacements: mesh {len(got[0])} "
          f"results, one device {len(got[1])}, before {len(want)}")
    # on the card: one launch for the single driver's resident copy, one
    # per touched shard for the mesh's (on the CPU the shards are views
    # of the host arrays: no launch)
    check(k5 == (1 + MESH_DATA[-1] if dev.type == "cuda" else 0),
          f"(d) K5 launched {k5} times")
    blocks = mesh_resident(mesh_drv, dev)
    leaves = check_resident(single, dev) if dev.type == "cuda" else 0
    rec["replaced_results"] = len(got[0])
    log(f"[mesh] (d) {MESH_REPLACED} Namespaces replaced, re-swept: "
        f"{len(got[0])} results equal in both drivers; K5 {k5} launches; "
        f"{blocks} shard blocks and {leaves} single-device leaves equal "
        "their host rows")


def audit_step(part: str, dev, n: int, c: int, violate_frac: float,
               data: int, model: int = 1):
    """make_audit_step on build_eval_setup(n, c, violate_frac) over a data
    x model mesh of virtual shards of `dev`, called twice: fires equal to
    the one-device sweep, counts (K6) equal to its column sums, the warm
    call equal to the first and K6 once a shard in it (on the card).
    Returns the template, the placed inputs, the warm call's fires and
    words (shard by shard), the counts and the seconds: setup_s of
    build_eval_setup, cold_s from before it to the end of the first call
    (the placement and the one-device sweep included), warm_s of the
    second call."""
    import torch

    from gatekeeper_tpu_torch.ir.carry import tree_from_numpy
    from gatekeeper_tpu_torch.parallel.collectives import make_audit_step
    from gatekeeper_tpu_torch.parallel.mesh import make_mesh
    from gatekeeper_tpu_torch.parallel.workload import build_eval_setup

    k6 = kernel_wrappers()["K6"]
    t_start = time.perf_counter()
    _drv, ct, feats, params, table, derived, reviews, _cons = \
        build_eval_setup(n, c, violate_frac=violate_frac, device=dev.type)
    n_valid = len(reviews)
    del reviews
    setup_s = time.perf_counter() - t_start
    fd = tree_from_numpy((feats, params, table, derived), dev)
    ones = ct.fires(*fd)
    mesh = make_mesh([dev] * (data * model), data=data, model=model)
    words: list = []  # the last call's words, shard by shard

    def eval_words(*a):
        words.append(ct.words(*a))
        return words[-1]

    step = make_audit_step(eval_words, mesh)
    fires, counts = step(feats, params, table, derived, n_valid)
    sync(dev)
    cold_s = time.perf_counter() - t_start
    words.clear()
    k6_step = k6.launches
    t0 = time.perf_counter()
    fires2, counts2 = step(feats, params, table, derived, n_valid)
    sync(dev)
    warm_s = time.perf_counter() - t0
    k6_step = k6.launches - k6_step
    check(dev.type != "cuda" or k6_step == data * model,
          f"({part}) the warm step launched K6 {k6_step} times, not once "
          f"a shard ({data * model})")
    check(torch.equal(fires, fires2) and torch.equal(counts, counts2),
          f"({part}) the warm step differs from the first")
    fires = fires.cpu().numpy()
    counts = counts.cpu().numpy()
    want_counts = ones[:n_valid].sum(axis=0)
    check(fires.shape == ones.shape and
          (fires[:n_valid] == ones[:n_valid]).all() and
          not fires[n_valid:].any(),
          f"({part}) make_audit_step's fires differ from the one-device "
          "sweep")
    check((counts == want_counts).all() and counts.sum() > 0,
          f"({part}) counts {counts.sum()} against column sums "
          f"{want_counts.sum()}")
    return types.SimpleNamespace(
        ct=ct, fd=fd, n_valid=n_valid, fires=fires2, words=words,
        pairs=int(counts.sum()), setup_s=setup_s, cold_s=cold_s,
        warm_s=warm_s, k6_step=k6_step)


def plane_mesh(report: dict, device: str = "cuda",
               n: int = CONFIG4[0]) -> None:
    """Phase 20: the audit mesh (parallel/mesh.py, parallel/collectives.py,
    the mesh half of ir/evaltorch.py and TorchDriver) over virtual shards
    of the one card: (a) no mesh by default on one card, with
    GATEKEEPER_TPU_MESH=2, or pinned to cuda:0; (b) config 4 at full
    width through TorchDriver(mesh=4 x cuda:0): one dispatch a shard,
    81,346 results equal in order to a single-device driver's; (c) the
    same over 2 shards, the slab loop; (d) 500 Namespaces replaced in
    (c)'s and the single driver, re-swept (not delta-served): equal
    results, K5 launched on the shards, every shard's resident rows equal
    the host's (mesh_audits); (e) make_audit_step over a 4 x 2 mesh of 8
    x cuda:0 on build_eval_setup (100,000 x 500): fires equal to the
    one-device sweep, counts equal to its column sums, K6 once a shard
    (its block of fires and its counts), then a warm call timed with
    its epilogue's share; (f) the join membership (K4) split over 8
    shards equal to one launch. The launch counters are zeroed before
    (b) and read after (f). Then (g) K6 against its plain version,
    exactly, at config 4's shard shape, ragged shapes and strided
    destinations, with its time, bound, plain and library times.
    `device` and `n` are for a rehearsal on the CPU at a small size."""
    import numpy as np
    import torch

    from gatekeeper_tpu_torch.ir import TorchDriver
    from gatekeeper_tpu_torch.ir import join as tjoin
    from gatekeeper_tpu_torch.ir.carry import tree_from_numpy
    from gatekeeper_tpu_torch.ir.features import _bucket
    from gatekeeper_tpu_torch.kernels.join_member import join_member
    from gatekeeper_tpu_torch.kernels.shard_counts import (
        shard_counts, shard_counts_plain)
    from gatekeeper_tpu_torch.parallel.mesh import (
        make_mesh, on_device, place, replicate)
    from tests.torch_kernel_cases import k4_synthetic

    dev0 = torch.device("cuda", 0) if device == "cuda" else \
        torch.device(device)
    cards = torch.cuda.device_count()
    rec: dict = {}
    # (a) one card: no mesh unless one is given, and none when pinned
    check(TorchDriver(device=device)._mesh is None,
          f"TorchDriver({device!r}) on one device has a mesh")
    old = os.environ.get("GATEKEEPER_TPU_MESH")
    os.environ["GATEKEEPER_TPU_MESH"] = "2"
    try:
        capped = TorchDriver(device=device)._mesh
    finally:
        if old is None:
            os.environ.pop("GATEKEEPER_TPU_MESH")
        else:
            os.environ["GATEKEEPER_TPU_MESH"] = old
    check((capped is None) == (device != "cuda" or cards < 2),
          f"GATEKEEPER_TPU_MESH=2 on {cards} card(s) gave {capped}")
    check(TorchDriver(device=f"{device}:0",
                      mesh=make_mesh([dev0] * 4))._mesh is None,
          f"a driver pinned to {device}:0 took a mesh")
    log(f"[mesh] (a) {cards} card(s) visible: no mesh by default, with "
        f"GATEKEEPER_TPU_MESH=2 or pinned to {device}:0")

    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t_path = time.perf_counter()
    mesh_audits(rec, dev0, n)
    settle(release=True)

    # (e) make_audit_step over data x model virtual shards
    data, model = MESH_STEP
    st = audit_step("e", dev0, n, CONFIG4[1], 0.01, data, model)
    ct, fd, n_valid, fires2 = st.ct, st.fd, st.n_valid, st.fires
    shard_words, k6_step = st.words, st.k6_step
    cold_s, warm_s = st.cold_s, st.warm_s
    # the epilogue alone, as the step runs it: one zeroed partial, then
    # K6 a shard into its block of fires (outside the launch counts)
    n_loc, c_loc = fires2.shape[0] // data, fires2.shape[1] // model
    blocks = [(shard_words[m * data + d], max(0, min(n_loc, n_valid -
                                                     d * n_loc)),
               fires2[d * n_loc:(d + 1) * n_loc, m * c_loc:(m + 1) * c_loc],
               slice(m * c_loc, (m + 1) * c_loc))
              for m in range(model) for d in range(data)]

    def epilogue():
        part = torch.zeros((fires2.shape[1],), dtype=torch.int32,
                           device=dev0)
        for w_, r_end, blk, cols in blocks:
            shard_counts(w_, 0, r_end, c_loc, blk, part[cols])

    k6_before = wrappers["K6"].launches
    epi_ms = cuda_ms(epilogue, reps=10)
    wrappers["K6"].launches = k6_before
    rec["step"] = {"pairs": st.pairs, "s": cold_s,
                   "warm_s": warm_s, "epilogue_ms": epi_ms,
                   "epilogue_share": epi_ms / (warm_s * 1e3)}
    log(f"[mesh] (e) make_audit_step over {data} x {model} virtual shards "
        f"of build_eval_setup({n}, {CONFIG4[1]}): fires equal to one "
        f"device's, counts (K6) equal to its column sums "
        f"({st.pairs} pairs), {cold_s:.1f} s; a warm call "
        f"{warm_s * 1e3:.3f} ms, K6 {k6_step} launches; the epilogue "
        f"(one zeroed partial + {k6_step} K6) {epi_ms:.5f} ms on the card, "
        f"{100 * epi_ms / (warm_s * 1e3):.2f}% of the warm call")

    # (f) the join membership split over shards
    arrs = k4_synthetic(*K4_AUDIT)
    one = join_member(*tree_from_numpy(arrs, dev0), tjoin.KEY_PAD)
    jm = make_mesh([dev0] * MESH_JOIN)
    tables = [replicate(a, jm) for a in arrs[:3]]
    rev = [place(a, jm, "data") for a in arrs[3:]]
    parts = []
    for d in range(MESH_JOIN):
        with on_device(jm.device(d)):
            parts.append(join_member(*(t.block(d) for t in tables),
                                     *(r.block(d) for r in rev),
                                     tjoin.KEY_PAD))
    split = torch.cat(parts)
    sync(dev0)
    check(torch.equal(split, one) and 0 < int(one.sum()) < one.shape[0],
          "(f) the sharded join membership differs from one launch")
    log(f"[mesh] (f) join membership (K4) over {MESH_JOIN} shards of "
        f"{arrs[3].shape[0]} reviews, Kb {arrs[0].shape[0]}: equal to one "
        f"launch ({int(one.sum())} fire)")
    launches = {k: w.launches for k, w in wrappers.items()}
    rec["path_s"] = time.perf_counter() - t_path
    check(device != "cuda" or
          all(launches[k] > 0 for k in ("K1", "K2", "K4", "K5", "K6")),
          f"a kernel of the mesh path never launched: {launches}")
    rec["launches"] = launches
    log(f"[mesh] path (b)-(f) {rec['path_s']:.1f} s; launches {launches}")

    # (g) K6 against its plain version, then timed at config 4's shard
    rng = np.random.default_rng(20)
    bucket = _bucket(n)
    n_loc = bucket // MESH_DATA[0]
    words = ct.words({s_: {k: a[:n_loc] for k, a in arrs_.items()}
                      for s_, arrs_ in fd[0].items()}, *fd[1:])
    last = ct.words({s_: {k: a[-n_loc:] for k, a in arrs_.items()}
                     for s_, arrs_ in fd[0].items()}, *fd[1:])
    c = CONFIG4[1]
    # (words, r_begin, r_end, c, C, destination rows x columns, row
    # stride, column offset)
    cases = [(words, 0, n_loc, c, c, c, 0),
             (last, 0, n_valid - (bucket - n_loc), c, c, c, 0)]
    for rows, w, dens, rb, re_, cc, C in K6_RAGGED:
        bits = torch.from_numpy(rng.random((rows, 32 * w)) < dens).to(dev0)
        cases.append((pack_bits(bits), rb, re_, cc, C, min(cc, 32 * w), 0))
    for rows, w, cc, ld, col in K6_STRIDED:
        bits = torch.from_numpy(rng.random((rows, 32 * w)) < 0.02).to(dev0)
        cases.append((pack_bits(bits), 0, rows - 1, cc, cc, ld, col))
    for wd, rb, re_, cc, C, ld, col in cases:
        f = min(cc, 32 * wd.shape[1])
        for acc in (False, True):
            res = []
            for fn in (shard_counts, shard_counts_plain):
                whole = torch.ones((wd.shape[0] + 2, max(ld, f)),
                                   dtype=torch.bool, device=dev0)
                block = whole[1:1 + wd.shape[0], col:col + f]
                init = (torch.arange(C, dtype=torch.int32, device=dev0) * 3
                        - 5) if acc else torch.zeros(C, dtype=torch.int32,
                                                     device=dev0)
                res.append((fn(wd, rb, re_, cc, block, init), whole))
            sync(dev0)
            (got, gw), (ref, rw) = res
            check(torch.equal(got, ref) and torch.equal(gw, rw),
                  f"K6 != plain at {list(wd.shape)} rows [{rb}, {re_}) c "
                  f"{cc} C {C} row stride {max(ld, f)} column {col} "
                  f"accumulate {acc}")
            if not acc:
                nset = int(ref.sum())
        log(f"[K6] {list(wd.shape)} rows [{rb}, {re_}) c {cc} C {C} into "
            f"row stride {max(ld, f)} at column {col}: fires and counts "
            f"exact, zeroed and accumulated ({nset} set bits)")
    # timed as the step writes it: the second shard's block of a
    # [4 n_loc, c] fires, and at (e)'s shape a [n_loc, 8] block at
    # column 250 of a [4 n_loc, 500] one
    dest = torch.empty((4 * n_loc, c), dtype=torch.bool, device=dev0)
    block = dest[n_loc:2 * n_loc]
    out = torch.zeros((c,), dtype=torch.int32, device=dev0)
    kms = cuda_ms(lambda: shard_counts(words, 0, n_loc, c, block, out))
    pms = cuda_ms(lambda: shard_counts_plain(words, 0, n_loc, c, block,
                                             out), reps=5)
    lms = cuda_ms(lambda: unpack_masked(words, 0, n_loc, c)[:, :c].sum(
        0, dtype=torch.int32), reps=5)
    half = c // 2
    w_e = words[:, :-(-half // 32)].contiguous()
    kms_e = cuda_ms(lambda: shard_counts(
        w_e, 0, n_loc, half, dest[n_loc:2 * n_loc, half:], out[half:]))
    nbytes = n_loc * words.shape[1] * 4 + n_loc * c + c * 4
    bms, by = bound_ms(nbytes, n_loc * c)
    bms_e, _ = bound_ms(n_loc * w_e.shape[1] * 4 + n_loc * half + half * 4,
                        n_loc * half)
    report["K6"] = {"max_abs_err": 0, "ms": kms, "plain_ms": pms,
                    "bound_ms": bms, "bound_by": by, "library_ms": lms,
                    "ms_e_shape": kms_e, "bound_ms_e_shape": bms_e}
    log(f"[K6] [{n_loc}, {words.shape[1]}] c {c} into row stride {c}: "
        f"kernel {kms:.5f} ms, bound {bms:.6f} ms ({by}, {nbytes} bytes), "
        f"plain {pms:.4f} ms, unpack + sum(0) {lms:.4f} ms; (e)'s shard "
        f"[{n_loc}, {w_e.shape[1]}] c {half} at column {half} of {c}: "
        f"{kms_e:.5f} ms, bound {bms_e:.6f} ms")
    report["mesh"] = rec


# phase 21: BENCH config 10's million-object audit at full width
# (bench_configs.py config10: REQUIRED_LABELS_TEMPLATE x C10_CONSTRAINTS
# synth_constraints over C10_OBJECTS synth_objects) on one device and
# over SCALE_SHARDS virtual shards of the card, its audit step at that
# shape, and BENCH config 1; in a child process of its own (`--scale`)
SCALE_SHARDS = 8
# the JAX package's counts, equal on one device and over 8 forced host
# devices, first and warm (tests/torch_reference_counts.py --config10
# 1000000): the total (BENCH_r07 config 10's violations), per
# constraint in synth_constraints' order, and the result digest
# (tests/torch_bench_configs.py result_digest)
SCALE_RESULTS = 29592
SCALE_PER_CONSTRAINT = (
    100, 174, 302, 184, 206, 100, 395, 280, 383, 118, 94, 460, 457, 479,
    194, 496, 298, 284, 89, 457, 173, 353, 295, 177, 378, 397, 103, 385,
    174, 208, 374, 86, 400, 378, 86, 563, 118, 277, 273, 463, 174, 86,
    360, 401, 572, 486, 283, 363, 362, 475, 198, 177, 277, 284, 580, 176,
    590, 280, 189, 100, 184, 192, 467, 94, 263, 295, 86, 390, 414, 577,
    194, 404, 280, 92, 362, 192, 184, 400, 291, 280, 85, 189, 451, 187,
    454, 468, 293, 370, 458, 86, 392, 363, 389, 374, 375, 294, 446, 479,
    87, 87)
SCALE_DIGEST = ("c89fb456b9b79e47e09df23fb911a73a"
                "3ba3b24d6208975a243b5cb989584f77")
# BENCH config 1: BENCH_r07's violations, the JAX package's TpuDriver's
# as decided and pinned and its RegoDriver's
# (tests/torch_reference_counts.py --config1)
CONFIG1_RESULTS = 1


def config10_client(driver, objs: list):
    """Config 10's client: the flagship template, C10_CONSTRAINTS
    synth_constraints(seed=1), the objects `objs`."""
    from gatekeeper_tpu_torch.client import Backend
    from gatekeeper_tpu_torch.parallel.workload import (
        REQUIRED_LABELS_TEMPLATE, synth_constraints)
    from gatekeeper_tpu_torch.target import K8sValidationTarget
    from tests.torch_bench_configs import C10_CONSTRAINTS

    client = Backend(driver).new_client([K8sValidationTarget()])
    client.add_template(REQUIRED_LABELS_TEMPLATE)
    for c in synth_constraints(C10_CONSTRAINTS, seed=1):
        client.add_constraint(c)
    for o in objs:
        client.add_data(o)
    return client


def peak_reset(dev) -> int:
    """Resets the device's peak memory; returns the bytes still
    allocated there (what an earlier part left resident)."""
    import torch

    # the caching allocator knows a device once it allocated there
    torch.zeros(1, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def scale_sweeps(part: str, drv, client) -> tuple:
    """Phase 21 (a) or (b): the first audit (K2 compiled in the
    foreground, the path the cost model takes), split by phase, then a
    full warm sweep with the delta cache cleared. Each sweep's results
    must give the JAX package's total, counts per constraint and
    digest, and K1 and K2 must launch. Returns (each sweep's result keys, the
    record, the dispatch handles of the first audit)."""
    from gatekeeper_tpu_torch.parallel.workload import synth_constraints
    from gatekeeper_tpu_torch.utils import profiling
    from tests.torch_bench_configs import (
        C10_CONSTRAINTS, per_constraint_counts, result_digest)

    cons = synth_constraints(C10_CONSTRAINTS, seed=1)
    handles: list = []
    dispatch = drv._dispatch_handle

    def spy(*a, **k):
        handles.append(dispatch(*a, **k))
        return handles[-1]

    rec: dict = {}
    keys = []
    drv._dispatch_handle = spy
    try:
        for sweep in ("first", "warm"):
            if sweep == "warm":
                drv._audit_results_cache.clear()
            before = launch_counts()
            timers0 = profiling.timers().snapshot()
            t0 = time.perf_counter()
            results = client.audit().results()
            wall = time.perf_counter() - t0
            split, line = phase_split(timers0, wall)
            k = launched(before)
            per = per_constraint_counts(results, cons)
            digest = result_digest(results)
            log(f"[scale] ({part}) {sweep} audit: {len(results)} results, "
                f"path {drv.last_audit_path}, launches {k}; by phase: "
                f"{line}")
            check(len(results) == SCALE_RESULTS and
                  tuple(per) == SCALE_PER_CONSTRAINT and
                  digest == SCALE_DIGEST,
                  f"({part}) the {sweep} audit: {len(results)} results, "
                  f"digest {digest}, per constraint {per}; the JAX "
                  f"package's: {SCALE_RESULTS}, {SCALE_DIGEST}")
            check(k["K1"] > 0 and k["K2"] > 0,
                  f"({part}) the {sweep} audit launched {k}")
            rec[sweep] = {"results": len(results),
                          "path": drv.last_audit_path,
                          "launches": k, "phases": split}
            keys.append(result_key(results))
            del results
            if sweep == "first":
                first_handles = list(handles)
    finally:
        drv._dispatch_handle = dispatch
    check(keys[0] == keys[1], f"({part}) the warm sweep's results differ "
          "from the first audit's")
    return keys, rec, first_handles


def scale_single(rec: dict, dev, objs: list) -> list:
    """Phase 21 (a): config 10 on one device (GATEKEEPER_TPU_MESH=off),
    two slabs of _sweep_slab rows. Returns the first audit's result
    keys."""
    import torch

    from gatekeeper_tpu_torch.ir import evaltorch
    from gatekeeper_tpu_torch.ops import regex_nfa
    from gatekeeper_tpu_torch.ops.strtab import vocab_cap
    from tests.torch_bench_configs import C10_CONSTRAINTS

    n = len(objs)
    old = os.environ.get("GATEKEEPER_TPU_MESH")
    os.environ["GATEKEEPER_TPU_MESH"] = "off"
    try:
        drv = foreground_driver()
    finally:
        if old is None:
            os.environ.pop("GATEKEEPER_TPU_MESH")
        else:
            os.environ["GATEKEEPER_TPU_MESH"] = old
    check(drv._mesh is None, f"(a) a driver with GATEKEEPER_TPU_MESH=off "
          f"has a mesh {drv._mesh}")
    rec["resident_bytes"] = peak_reset(dev)
    t0 = time.perf_counter()
    client = config10_client(drv, objs)
    rec["ingest_s"] = time.perf_counter() - t0
    settle()
    k3_before = kernel_wrappers()["K3"].launches
    keys, sweeps, handles = scale_sweeps("a", drv, client)
    k3 = kernel_wrappers()["K3"].launches - k3_before
    ct = drv.compiled_for("K8sRequiredLabels")
    slab = drv._sweep_slab(n, drv.sweep_chunk)
    slabs = [len(h._pend) for h in handles
             if isinstance(h, evaltorch._SlabPairs)]
    check(all(s["path"] == "single(cuda)" for s in sweeps.values()),
          f"(a) paths {[s['path'] for s in sweeps.values()]}")
    check(slab == 507_904 and slabs == [2],
          f"(a) slab {slab}, slabs per handle {slabs}")
    # the template's regex rows span the vocabulary (label values only:
    # it reads no names), so K3 runs iff that reaches the crossover
    evals = sum(op == "re_match" for op, _p in drv.match_tables._patterns
                ) * len(drv.strtab)
    check((k3 > 0) == (evals >= regex_nfa.DEVICE_CROSSOVER),
          f"(a) {evals} regex evaluations, DEVICE_CROSSOVER "
          f"{regex_nfa.DEVICE_CROSSOVER}, K3 launches {k3}")
    rec.update(sweeps, slab=slab, slabs=slabs[0],
               rows_cap=ct._rows_cap, vocab=len(drv.strtab),
               vocab_cap=vocab_cap(len(drv.strtab)), regex_evals=evals,
               k3=k3, peak_bytes=torch.cuda.max_memory_allocated(dev))
    log(f"[scale] (a) config 10 ({n} objects x {C10_CONSTRAINTS} "
        f"constraints) on one device: ingest {rec['ingest_s']:.1f} s, "
        f"first audit {sweeps['first']['phases']['wall_s']:.3f} s, warm "
        f"sweep {sweeps['warm']['phases']['wall_s']:.3f} s; "
        f"{rec['slabs']} slabs of {slab} rows, pair capacity "
        f"{ct._rows_cap}, vocabulary {rec['vocab']} (capacity "
        f"{rec['vocab_cap']}; {evals} regex evaluations, K3 {k3}); peak "
        f"device memory {rec['peak_bytes']} bytes ({rec['resident_bytes']} "
        "resident before)")
    FOREGROUND.discard(drv)
    return keys[0]


def scale_mesh(rec: dict, dev, objs: list, want: list) -> None:
    """Phase 21 (b): the same objects on a driver given an explicit mesh
    of SCALE_SHARDS x `dev`: path mesh(data=8), the local slab loop,
    results equal in order to (a)'s on the first audit and the warm
    sweep."""
    import torch

    from gatekeeper_tpu_torch.ir import evaltorch
    from gatekeeper_tpu_torch.ir.features import _bucket
    from gatekeeper_tpu_torch.parallel.mesh import make_mesh

    n = len(objs)
    drv = foreground_driver(mesh=make_mesh([dev] * SCALE_SHARDS))
    rec["resident_bytes"] = peak_reset(dev)
    t0 = time.perf_counter()
    client = config10_client(drv, objs)
    rec["ingest_s"] = time.perf_counter() - t0
    settle()
    keys, sweeps, handles = scale_sweeps("b", drv, client)
    ct = drv.compiled_for("K8sRequiredLabels")
    rows = _bucket(n)
    lslab = ct._mesh_plan(rows, SCALE_SHARDS, drv.sweep_chunk,
                          drv.mesh_slab_local)[2]
    slabbed = [isinstance(h, evaltorch._MeshSlabPairs) for h in handles]
    check(all(s["path"] == f"mesh(data={SCALE_SHARDS})"
              for s in sweeps.values()),
          f"(b) paths {[s['path'] for s in sweeps.values()]} (mesh "
          f"{drv._mesh}, quarantined {drv.quarantine_status()})")
    check(slabbed == [True] and rows // SCALE_SHARDS == 131_072 and
          lslab == 16_384,
          f"(b) bucket {rows}, local slab {lslab}, handles slabbed "
          f"{slabbed}")
    check(keys[0] == want and keys[1] == want,
          f"(b) the mesh(data={SCALE_SHARDS}) results differ from (a)'s "
          f"({len(keys[0])} and {len(keys[1])} against {len(want)}, order "
          "included)")
    rec.update(sweeps, n_loc=rows // SCALE_SHARDS, local_slab=lslab,
               rows_cap_mesh=ct._rows_cap_mesh,
               peak_bytes=torch.cuda.max_memory_allocated(dev))
    log(f"[scale] (b) config 10 over {SCALE_SHARDS} virtual shards: the "
        f"slab loop, {rows // SCALE_SHARDS // lslab} slabs of {lslab}, "
        f"n_loc {rows // SCALE_SHARDS}; ingest {rec['ingest_s']:.1f} s, "
        f"first audit {sweeps['first']['phases']['wall_s']:.3f} s, warm "
        f"sweep {sweeps['warm']['phases']['wall_s']:.3f} s; results equal "
        f"to (a)'s in order; pair capacity a shard {ct._rows_cap_mesh}; "
        f"peak device memory {rec['peak_bytes']} bytes ("
        f"{rec['resident_bytes']} resident before)")
    FOREGROUND.discard(drv)


def scale_step(rec: dict, report: dict, dev) -> None:
    """Phase 21 (c): make_audit_step on build_eval_setup(C10_OBJECTS,
    C10_CONSTRAINTS) (config 10's objects) over SCALE_SHARDS virtual
    shards (audit_step); then K6 alone at the shard's shape, timed
    beside its bytes bound."""
    import torch

    from gatekeeper_tpu_torch.kernels.shard_counts import shard_counts
    from tests.torch_bench_configs import (
        C10_CONSTRAINTS, C10_OBJECTS, C10_VIOLATE_FRAC)

    wrappers = kernel_wrappers()
    rec["resident_bytes"] = peak_reset(dev)
    st = audit_step("c", dev, C10_OBJECTS, C10_CONSTRAINTS,
                    C10_VIOLATE_FRAC, SCALE_SHARDS)
    # K6 alone at the step's shard shape, into the second shard's block
    # of the warm call's fires (outside the launch counts)
    n_loc, c = st.fires.shape[0] // SCALE_SHARDS, st.fires.shape[1]
    words = st.words[1]
    block = st.fires[n_loc:2 * n_loc]
    part = torch.zeros((c,), dtype=torch.int32, device=dev)
    k6_before = wrappers["K6"].launches
    kms = cuda_ms(lambda: shard_counts(words, 0, n_loc, c, block, part))
    wrappers["K6"].launches = k6_before
    nbytes = n_loc * words.shape[1] * 4 + n_loc * c + c * 4
    bms, by = bound_ms(nbytes, n_loc * c)
    rec.update(setup_s=st.setup_s, pairs=st.pairs, s=st.cold_s,
               warm_s=st.warm_s, k6_step=st.k6_step, n_loc=n_loc,
               words=list(words.shape),
               peak_bytes=torch.cuda.max_memory_allocated(dev))
    report["K6_scale"] = {"ms": kms, "bound_ms": bms, "bound_by": by,
                          "bytes": nbytes, "shape": [n_loc,
                                                     words.shape[1], c]}
    log(f"[scale] (c) make_audit_step over {SCALE_SHARDS} virtual shards "
        f"of build_eval_setup({C10_OBJECTS}, {C10_CONSTRAINTS}) (set-up "
        f"{st.setup_s:.1f} s): fires equal to one device's, counts (K6) "
        f"equal to its column sums ({st.pairs} pairs); from set-up to the "
        f"first call's end {st.cold_s:.1f} s, a warm call "
        f"{st.warm_s * 1e3:.3f} ms with K6 {st.k6_step} launches; K6 at "
        f"the shard's [{n_loc}, {words.shape[1]}], c {c}: {kms:.5f} ms, "
        f"bound {bms:.6f} ms "
        f"({by}, {nbytes} bytes); peak device memory {rec['peak_bytes']} "
        f"bytes ({rec['resident_bytes']} resident before)")


def scale_config1(rec: dict, dev) -> None:
    """Phase 21 (d): BENCH config 1 as the cost model decides and pinned
    to the device: the JAX package's count, results equal to the port's
    RegoDriver."""
    from gatekeeper_tpu_torch import policies
    from gatekeeper_tpu_torch.client import Backend, RegoDriver
    from gatekeeper_tpu_torch.parallel.workload import synth_objects
    from gatekeeper_tpu_torch.target import K8sValidationTarget
    from tests.torch_bench_configs import (
        C1_CONSTRAINT, C1_OBJECTS, C1_VIOLATE_FRAC)
    from tests.torch_fuzz_gen import pin

    objs = synth_objects(C1_OBJECTS, violate_frac=C1_VIOLATE_FRAC, seed=7)
    got = {}
    for what in ("rego", "decided", "pinned"):
        drv = RegoDriver() if what == "rego" else foreground_driver()
        if what == "pinned":
            pin(drv)
        client = Backend(drv).new_client([K8sValidationTarget()])
        client.add_template(policies.load("general/requiredlabels"))
        client.add_constraint(C1_CONSTRAINT)
        for o in objs:
            client.add_data(o)
        before = launch_counts()
        got[what] = result_key(client.audit().results())
        if what != "rego":
            rec[what] = {"results": len(got[what]),
                         "path": drv.last_audit_path,
                         "launches": launched(before)}
    check(rec["pinned"]["path"] == "single(cuda)",
          f"(d) the pinned audit took path {rec['pinned']['path']}")
    for what in ("decided", "pinned"):
        check(len(got[what]) == CONFIG1_RESULTS and got[what] == got["rego"],
              f"(d) config 1 {what}: {len(got[what])} results, the JAX "
              f"package's {CONFIG1_RESULTS}, RegoDriver's "
              f"{len(got['rego'])}")
    log(f"[scale] (d) config 1 ({C1_OBJECTS} objects): {CONFIG1_RESULTS} "
        f"result(s) as decided (path {rec['decided']['path']}, launches "
        f"{rec['decided']['launches']}) and pinned (path "
        f"{rec['pinned']['path']}, launches {rec['pinned']['launches']}), "
        "equal to RegoDriver's")


def plane_scale(report: dict) -> None:
    """Phase 21: BENCH config 10 at full width (1,000,000 objects x 100
    constraints, not cut) and BENCH config 1 on the card: (a) one device
    (scale_single), (b) SCALE_SHARDS virtual shards (scale_mesh), (c)
    the audit step at config 10's shape (scale_step), (d) config 1
    (scale_config1). The launch counters are zeroed before (a) and read
    after (d)."""
    import torch

    from gatekeeper_tpu_torch.parallel.workload import synth_objects
    from tests.torch_bench_configs import C10_OBJECTS, C10_VIOLATE_FRAC

    dev = torch.device("cuda", 0)
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    rec: dict = {"objects": C10_OBJECTS}
    t_path = time.perf_counter()
    t0 = time.perf_counter()
    objs = synth_objects(C10_OBJECTS, violate_frac=C10_VIOLATE_FRAC, seed=0)
    rec["synth_s"] = time.perf_counter() - t0
    settle()
    rec["single"] = {}
    want = scale_single(rec["single"], dev, objs)
    settle(release=True)
    rec["mesh"] = {}
    scale_mesh(rec["mesh"], dev, objs, want)
    del objs, want
    settle(release=True)
    torch.cuda.empty_cache()
    rec["step"] = {}
    scale_step(rec["step"], report, dev)
    settle(release=True)
    rec["config1"] = {}
    scale_config1(rec["config1"], dev)
    launches = {k: w.launches for k, w in wrappers.items()}
    rec["path_s"] = time.perf_counter() - t_path
    check(all(launches[k] > 0 for k in ("K1", "K2", "K6")),
          f"a kernel of the scale path never launched: {launches}")
    rec["launches"] = launches
    log(f"[scale] path (a)-(d) {rec['path_s']:.1f} s; launches {launches}")
    report["scale"] = rec


def scale(dev) -> dict:
    """Phase 21, in the child process (`--scale`) that the smoke runs
    beside phases 7-14. Returns its records."""
    from batch_profile import GcClock

    gc.set_threshold(*GC_THRESHOLD)
    report: dict = {}
    t0 = time.perf_counter()
    run_phase(GcClock(), "scale", plane_scale, report)
    report["scale"]["phase_s"] = time.perf_counter() - t0
    return report


def phase_scale_child(report: dict, child: ChildProcess) -> None:
    """Waits for phase 21's child process (scale), started before phase
    7, prints its lines and takes its records."""
    code, out, err, el, _left = child.wait(1100, "the scale child")
    for line in (out[:-1] if code == 0 else out):
        log(line)
    for line in err[-40:]:
        log(f"[scale] child stderr: {line}")
    check(code == 0 and out, f"the scale child {child_exit(code, err)}")
    report.update(json.loads(out[-1])["scale_child"])
    log(f"[scale] phase 21 took {el:.1f} s in a child process beside "
        "phases 7-14")


def plane(dev) -> dict:
    """Phases 18, 19 and 20, in the child process (`--plane`) that the
    smoke runs beside phases 7-14: (a) the sharded audit, (b) the
    N-engine admission plane, (c) the policy service; then the offline
    fleet scan; then the audit mesh on virtual shards. Returns their
    records."""
    from batch_profile import GcClock

    gc.set_threshold(*GC_THRESHOLD)
    gc_clock = GcClock()
    report: dict = {}
    run_phase(gc_clock, "plane, sharded audit", plane_sharded, report)
    run_phase(gc_clock, "plane, admission engines", plane_engines, report)
    run_phase(gc_clock, "plane, policy service", plane_service, report)
    run_phase(gc_clock, "plane, fleet scan", plane_scan, report)
    settle(release=True)
    t0 = time.perf_counter()
    run_phase(gc_clock, "mesh", plane_mesh, report)
    report["mesh"]["phase_s"] = time.perf_counter() - t0
    return report


def phase_plane_child(report: dict, child: ChildProcess) -> None:
    """Waits for the child process of phases 18, 19 and 20 (plane),
    started before phase 7, prints its lines and takes its records."""
    code, out, err, el, _left = child.wait(1100, "the plane child")
    for line in (out[:-1] if code == 0 else out):
        log(line)
    for line in err[-40:]:
        log(f"[plane] child stderr: {line}")
    check(code == 0 and out, f"the plane child {child_exit(code, err)}")
    report.update(json.loads(out[-1])["plane_child"])
    web = report["webhook"]["cost model"]
    eng = report["plane_engines"]
    log(f"[plane] admission plane p50 {eng['p50_ms']:.3f} ms, p99 "
        f"{eng['p99_ms']:.3f} ms, {eng['rps']:.1f} requests/s beside phase "
        f"9b's in-process pass as the cost model decides: p50 "
        f"{web['p50_ms']:.3f} ms, p99 {web['p99_ms']:.3f} ms, "
        f"{web['rps']:.1f} requests/s")
    log(f"[plane] phases 18, 19 and 20 took {el:.1f} s in a child process "
        f"beside phases 7-14 (phase 20 {report['mesh']['phase_s']:.1f} s)")


def smi_query() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi: no output"


def run_phase(gc_clock, name: str, fn, *args):
    """One phase: settle the heap, run it, print its wall clock and its
    collector seconds, and fail on any quarantine of a foreground
    driver (phase 15, which injects faults, excepted)."""
    settle()
    gc_clock.read()
    t0 = time.perf_counter()
    out = fn(*args)
    gc_s = gc_clock.read()["gc_s"]
    log(f"[{name}] phase {time.perf_counter() - t0:.1f} s ({gc_s:.1f} s "
        "of it in Python's garbage collector)")
    if fn is not phase_lifecycle:  # only phase 15 injects faults
        no_quarantine(f"phase {name}")
    return out


def lifecycle(dev) -> dict:
    """Phases 15 and 16, in the child process (`--lifecycle`) that the
    smoke runs beside phases 7-14: the compile lifecycle, whose part (a)
    fills a program store under _build/, and the warm boot on it; then
    phase 9d (b), the streaming audit, phase 12, the churn subset, and
    phase 17, the entry point cold then warm. Returns their records."""
    from batch_profile import GcClock

    gc.set_threshold(*GC_THRESHOLD)
    gc_clock = GcClock()
    report: dict = {}
    aot_dir = tempfile.mkdtemp(prefix="aot-", dir=os.path.join(
        ROOT, "gatekeeper_tpu_torch", "_build"))
    child = None
    try:
        child = run_phase(gc_clock, "lifecycle", phase_lifecycle, dev,
                          report, aot_dir)
        run_phase(gc_clock, "warm boot", phase_warm_boot, dev, report,
                  child)
    finally:
        if child is not None:
            child.stop()
        shutil.rmtree(aot_dir, ignore_errors=True)
    run_phase(gc_clock, "audit manager, streaming", phase_audit_stream,
              dev, report, smi_query())
    run_phase(gc_clock, "churn subset", phase_churn_subset, dev)
    run_phase(gc_clock, "entry", phase_entry, dev, report)
    return {k: report[k] for k in ("lifecycle", "warm_boot",
                                   "audit_stream", "entry")}


def phase_lifecycle_child(report: dict, child: ChildProcess) -> None:
    """Waits for the child process of phases 15, 16, 9d (b), 12 and 17
    (lifecycle), started before phase 7, prints its lines and takes its
    records."""
    code, out, err, el, _left = child.wait(1100, "the lifecycle child")
    for line in (out[:-1] if code == 0 else out):
        log(line)
    for line in err[-40:]:
        log(f"[lifecycle] child stderr: {line}")
    check(code == 0 and out, f"the lifecycle child {child_exit(code, err)}")
    report.update(json.loads(out[-1])["lifecycle_child"])
    log(f"[lifecycle] phases 15, 16, 9d (b), 12 and 17 took {el:.1f} s in "
        "a child process beside phases 7-14")


def main() -> int:
    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--kernels", nargs="?", const="K1,K2,K3,K4,K5,K6",
                    metavar="K1,K2,K3,K4,K5,K6",
                    help="kernels alone, all six or those named (see "
                    "kernels_only)")
    ap.add_argument("--tune", action="store_true",
                    help="with --kernels: time every K2 tile of "
                    "TUNE_CONFIGS and every K4 LINE")
    ap.add_argument("--root", default=ROOT,
                    help="with --kernels: the checkout whose package is "
                    "imported (default: this script's own)")
    ap.add_argument("--warm-boot", metavar="DIR",
                    help="phase 16's child: boot config 6 on the program "
                    "store at DIR and check its first audit (warm_boot)")
    ap.add_argument("--lifecycle", action="store_true",
                    help="phases 15, 16, 9d (b), 12 and 17 alone, as the "
                    "smoke's child beside phases 7-14 (lifecycle)")
    ap.add_argument("--plane", action="store_true",
                    help="phases 18, 19 and 20 alone, as the smoke's "
                    "child beside phases 7-14 (plane)")
    ap.add_argument("--mesh", action="store_true",
                    help="phase 20 alone: the kernels built, then the "
                    "audit mesh on virtual shards (plane_mesh)")
    ap.add_argument("--scale", action="store_true",
                    help="phase 21 alone, as the smoke's child beside "
                    "phases 7-14: the kernels built, then BENCH config "
                    "10's million-object audit on one device and on 8 "
                    "virtual shards, its audit step, and config 1 "
                    "(plane_scale)")
    ap.add_argument("--scan-run", nargs=2, metavar=("MODE", "CFG"),
                    help="phase 19's children: one fleet scan, cli, cold "
                    "or warm, configured by the JSON file CFG (scan_run)")
    ap.add_argument("--entry", nargs=2, metavar=("MODE", "DIR"),
                    help="phase 17's children: boot the entry point "
                    "cold (entry_cold) or warm (entry_warm) on the "
                    "state dir DIR")
    ap.add_argument("--loadgen", metavar="FILE",
                    help="phase 9b's child: send FILE's AdmissionReviews "
                    "to the webhook it names (loadgen)")
    args = ap.parse_args()
    if args.loadgen:
        # no card, torch or package needed; the load generator allocates
        # no cycles, and a collection here would count as server latency
        gc.disable()
        loadgen(args.loadgen)
        return 0
    root = os.path.abspath(args.root)
    if root != ROOT and not args.kernels:
        ap.error("--root is for --kernels runs")
    which = set((args.kernels or "").split(",")) - {""}
    if which - {"K1", "K2", "K3", "K4", "K5", "K6"} or \
            (args.tune and not {"K2", "K4"} & which):
        ap.error(f"--kernels takes K1, K2, K3, K4, K5, K6 (K2 or K4 with "
                 f"--tune), got {args.kernels}")
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
    if args.lifecycle:
        try:
            rec = lifecycle(torch.device("cuda"))
        except Fail as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"lifecycle_child": rec}))
        return 0
    if args.plane:
        try:
            rec = plane(torch.device("cuda"))
        except Fail as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"plane_child": rec}))
        return 0
    if args.scale:
        from gatekeeper_tpu_torch.kernels.build import build_all

        build_all()
        try:
            rec = scale(torch.device("cuda"))
        except Fail as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"scale_child": rec}))
        return 0
    if args.mesh:
        from gatekeeper_tpu_torch.kernels.build import build_all

        build_all()
        gc.set_threshold(*GC_THRESHOLD)
        rec: dict = {}
        try:
            t0 = time.perf_counter()
            plane_mesh(rec)
            no_quarantine("phase 20")
        except Fail as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        log(f"[mesh] phase 20 alone {time.perf_counter() - t0:.1f} s")
        print(json.dumps({k: rec[k] for k in ("mesh", "K6")}))
        return 0
    if args.entry:
        mode, state_dir = args.entry
        if mode not in ("cold", "warm"):
            ap.error(f"--entry takes cold or warm, got {mode}")
        gc.set_threshold(*GC_THRESHOLD)
        try:
            rec = (entry_cold if mode == "cold" else entry_warm)(state_dir)
        except Fail as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"entry": rec}))
        return 0
    if args.scan_run:
        mode, cfg_path = args.scan_run
        if mode not in ("cli", "cold", "warm"):
            ap.error(f"--scan-run takes cli, cold or warm, got {mode}")
        gc.set_threshold(*GC_THRESHOLD)
        try:
            rec = scan_run(mode, cfg_path)
        except Fail as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"scan_run": rec}))
        return 0
    if args.warm_boot:
        gc.set_threshold(*GC_THRESHOLD)
        try:
            rec = warm_boot(args.warm_boot)
        except Fail as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"warm_boot": rec}))
        return 0
    if args.kernels:
        # a Triton cache of this run's own, so that every first launch
        # compiles; removed at exit
        build = os.path.join(root, "gatekeeper_tpu_torch", "_build")
        os.makedirs(build, exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="triton-", dir=build) as tc:
            os.environ["TRITON_CACHE_DIR"] = tc
            try:
                kernels_only(torch.device("cuda"), args.tune,
                             os.path.relpath(root, ROOT), which)
            except Fail as e:
                print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
                return 1
        return 0
    wrappers = kernel_wrappers()
    t_all = time.perf_counter()
    smi_line = smi_query()
    log(smi_line)
    kind = torch.cuda.get_device_name(0)
    log(f"[card] torch {torch.__version__} (CUDA {torch.version.cuda}) on "
        f"{kind}, {torch.cuda.device_count()} visible")
    # every phase runs on torch.device("cuda"), the current card: one
    dev = torch.device("cuda")
    cards_used = 1
    report: dict = {}

    from batch_profile import GcClock

    gc.set_threshold(*GC_THRESHOLD)
    gc_clock = GcClock()

    def phase(name, fn, *args):
        return run_phase(gc_clock, name, fn, *args)

    lifecycle_child = plane_child = scale_child = None
    try:
        phase("build", phase_build, report)
        phase("K1", phase_k1, dev)
        flag_drv, lib_drv = phase("K2", phase_k2, dev, report)
        phase("K3", phase_k3, dev, report, flag_drv, lib_drv)
        del flag_drv, lib_drv
        settle(release=True)
        phase("K4", phase_k4_synthetic, dev)
        # phases 15, 16, 9d (b) and 12 in a child process beside phases
        # 7-14 (their kernels built by phase 2; phases 15 and 16 in Triton
        # caches of their own): the smoke's wall clock is the longer of
        # the two
        lifecycle_child = ChildProcess("lifecycle-", ["--lifecycle"])
        # phase 18 in a child process of its own, beside them too
        plane_child = ChildProcess("plane-", ["--plane"])
        # phase 21 in a child process of its own, beside them too
        scale_child = ChildProcess("scale-", ["--scale"])
        # the main path: counts from 0, driven, read just after
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        phase("audit", phase_audit, dev, report)
        settle(release=True)  # config 4's driver, frozen after its ingest
        big, small = phase("general", phase_general, dev, report)
        churn_drv, c6_k2 = phase("churn", phase_churn, dev, report)
        served = phase("batch", phase_batches, dev, report)
        launches = {k: w.launches for k, w in wrappers.items()}
        log(f"[main] audits + batches {time.perf_counter() - t0:.1f} s; "
            f"launches {launches}")
        # K6 is the mesh's (phase 20): the main path has no mesh on one card
        check(all(v > 0 for k, v in launches.items() if k != "K6"),
              f"a kernel of the main path never launched: {launches}")
        # the admission webhook's path: counts from 0, driven, read just
        # after (K2 serves its batches; K1 and K4 only past their
        # thresholds, which a 256-review micro-batch does not reach)
        for w in wrappers.values():
            w.launches = 0
        phase("webhook", phase_webhook, dev, report, served, small,
              smi_line)
        launches_webhook = {k: w.launches for k, w in wrappers.items()}
        log(f"[main] webhook launches {launches_webhook}")
        check(launches_webhook["K2"] > 0,
              f"K2 never launched on the webhook's path: {launches_webhook}")
        # the controllers' path: counts from 0, driven, read just after
        for w in wrappers.values():
            w.launches = 0
        planes = phase("controllers", phase_controllers, dev, report,
                       served, smi_line)
        launches_controllers = {k: w.launches for k, w in wrappers.items()}
        log(f"[main] controllers launches {launches_controllers}")
        check(launches_controllers["K2"] > 0, f"K2 never launched on the "
              f"controllers' path: {launches_controllers}")
        # the audit manager's path: counts from 0, driven, read just after
        for w in wrappers.values():
            w.launches = 0
        phase("audit manager", phase_audit_manager, dev, report, planes,
              smi_line)
        del planes
        launches_audit = {k: w.launches for k, w in wrappers.items()}
        log(f"[main] audit manager (a) launches {launches_audit}")
        check(launches_audit["K2"] > 0, f"K2 never launched on the audit "
              f"manager's default sweeps: {launches_audit}")
        del served, small
        settle(release=True)
        phase("general subset", phase_general_subset, dev)
        phase("path shapes", phase_k4_shapes, dev, report, big)
        del big
        settle(release=True)
        phase("K5 path shape", phase_k5_path, dev, report, churn_drv)
        del churn_drv
        phase("K2 config-6 shapes", phase_k2_config6, dev, report, c6_k2)
        del c6_k2
        settle(release=True)
        phase("lifecycle child", phase_lifecycle_child, report,
              lifecycle_child)
        # phase 9d's launches: (a) here, (b) counted in the child
        stream = report["audit_stream"]["launches"]
        launches_audit = {k: v + stream[k] for k, v in launches_audit.items()}
        log(f"[main] audit manager launches {launches_audit} ((b) in the "
            f"child: {stream})")
        check(launches_audit["K1"] > 0 and launches_audit["K2"] > 0,
              f"K1 or K2 never launched on the audit manager's path: "
              f"{launches_audit}")
        # phase 17's launches, counted in its two children
        launches_entry = report["entry"]["launches"]
        log(f"[main] entry launches {launches_entry} (cold "
            f"{report['entry']['cold']['launches']}, warm "
            f"{report['entry']['warm']['launches']})")
        phase("plane child", phase_plane_child, report, plane_child)
        # phase 18's launches in its own process: the policy service's
        # (c), counted from 0 before it and read after it (the shard and
        # engine children's show in their relayed duty cycle)
        launches_plane = report["plane_service"]["launches"]
        log(f"[main] plane launches {launches_plane} (the policy service)")
        # phase 19's launches: each run counted from 0 in the process that
        # evaluated it ((a)-(c) their children, (d) and (e) the plane
        # child) and read just after it
        launches_scan = report["plane_scan"]["launches"]
        per_run = {k: r["launches"]
                   for k, r in report["plane_scan"]["runs"].items()}
        log(f"[main] scan launches {launches_scan} (per run: {per_run})")
        # phase 20's launches, counted in the plane child from 0 before
        # (b) and read after (f)
        launches_mesh = report["mesh"]["launches"]
        log(f"[main] mesh launches {launches_mesh}")
        phase("scale child", phase_scale_child, report, scale_child)
        # phase 21's launches, counted in its child from 0 before (a) and
        # read after (d)
        launches_scale = report["scale"]["launches"]
        log(f"[main] scale launches {launches_scale}")
    except Fail as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        for child in (lifecycle_child, plane_child, scale_child):
            if child is not None:
                child.stop()
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
        "K6": ("K6 shard_counts", "cuda",
               "gatekeeper_tpu_torch/csrc/shard_counts.cu",
               "gatekeeper_tpu/parallel/collectives.py:27"),
    }
    # each kernel's `launches` is its count on the path that runs it: the
    # main path (phases 7-9) for K1-K5, the mesh (phase 20) for K6, which
    # no path of one card without a mesh launches
    launches = dict(launches, K6=launches_mesh["K6"])
    # K6 at phase 21 (c)'s shard shape beside its phase 20 record
    report["K6"].update({f"scale_{k}": v
                         for k, v in report["K6_scale"].items()})
    kernels = [dict(name=name, route=route, source=src, replaces=where,
                    launches=launches[k],
                    launches_webhook=launches_webhook[k],
                    launches_controllers=launches_controllers[k],
                    launches_audit=launches_audit[k],
                    launches_entry=launches_entry[k],
                    launches_plane=launches_plane[k],
                    launches_scan=launches_scan[k],
                    launches_mesh=launches_mesh[k],
                    launches_scale=launches_scale[k],
                    **report[k])
               for k, (name, route, src, where) in sources.items()]
    k2_c6 = {k: v for k, v in report["K2_config6"].items() if k != "kinds"}
    log(f"[done] {time.perf_counter() - t_all:.1f} s; audit "
        f"{json.dumps(report['audit'])}; config 6 "
        f"{json.dumps(report['config6'])}; K2 config 6 "
        f"{json.dumps(k2_c6)}; K2 flagship "
        f"{json.dumps(report['K2_flagship'])}; K5 path "
        f"{json.dumps(report['K5_path'])}; K3 crossover "
        f"{json.dumps(report['K3_crossover'])}; K4 break-even "
        f"{json.dumps(report['K4_break_even'])}; webhook "
        f"{json.dumps(report['webhook'])}; previews "
        f"{json.dumps(report['previews'])}; controllers "
        f"{json.dumps(report['controllers'])}; audit manager "
        f"{json.dumps(report['audit_manager'])}; audit manager, streaming "
        f"{json.dumps(report['audit_stream'])}; lifecycle "
        f"{json.dumps(report['lifecycle'])}; warm boot "
        f"{json.dumps(report['warm_boot'])}; entry "
        f"{json.dumps(report['entry'])}; plane "
        f"{json.dumps({k: report[k] for k in PLANE_RECORDS})}; mesh "
        f"{json.dumps(report['mesh'])}; scale "
        f"{json.dumps(report['scale'])}")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": cards_used}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
