#!/usr/bin/env python3
"""Where a review batch's time goes in the PyTorch/CUDA port.

    python3 batch_profile.py [--root DIR] [--device cuda] [--n 8192]
                             [--variants pr1,all23,all23+inv] [--profile]

Runs one `Client.review_batch` of n fleet-scan corpus manifests (the
corpus cycled with renamed copies past its 2,000 objects, as chip_smoke.py
builds it) through `TorchDriver`, in up to three setups:

  pr1        the 21 templates without the two join kinds, no inventory
             (chip_smoke.py's review-batch workload before the join path);
  all23      all 23 shipped templates, no inventory;
  all23+inv  all 23 templates with the 2,000 corpus objects loaded as
             inventory (chip_smoke.py's review-batch workload now).

Each setup warms its client with a batch of 512 (Triton compiles), then
times the n-manifest batch twice (first, steady), as chip_smoke.py's
review-batch phase runs a 512 batch before its 8,192 one. With --profile,
the last setup runs once more, on a new client, with its first n batch
under cProfile, and the functions that take the most time are printed. --root names the checkout whose
gatekeeper_tpu_torch is imported (default: this script's own), so that two
commits can be compared on one card. Prints one JSON line per setup,
with the seconds each timed batch spent in Python's garbage collector.
"""

from __future__ import annotations

import argparse
import cProfile
import gc
import io
import json
import os
import pstats
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
JOINS = {"general/uniqueingresshost", "general/uniqueserviceselector"}


class GcClock:
    """Seconds spent in Python's cyclic garbage collector, and its
    collections per generation, through gc.callbacks."""

    def __init__(self):
        self.seconds = 0.0
        self.collections = [0, 0, 0]
        self._t0 = 0.0
        gc.callbacks.append(self._on)

    def _on(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0
            self.collections[info["generation"]] += 1

    def stop(self) -> None:
        gc.callbacks.remove(self._on)

    def read(self) -> dict:
        out = {"gc_s": self.seconds, "gc_collections": list(self.collections)}
        self.seconds, self.collections = 0.0, [0, 0, 0]
        return out


def corpus(root: str, n: int) -> list[dict]:
    path = os.path.join(root, "tests", "fixtures", "fleet_scan",
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


def client_for(variant: str, device: str, root: str):
    from gatekeeper_tpu_torch import policies
    from gatekeeper_tpu_torch.client import Backend
    from gatekeeper_tpu_torch.ir import TorchDriver
    from gatekeeper_tpu_torch.parallel.workload import (
        GENERAL_CONSTRAINTS, PSP_CONSTRAINTS)
    from gatekeeper_tpu_torch.target import K8sValidationTarget

    drv = TorchDriver(device=device)
    drv.async_warm = False  # the warm-up batch compiles in the foreground
    client = Backend(drv).new_client([K8sValidationTarget()])
    names = [n for n in policies.names()
             if variant != "pr1" or n not in JOINS]
    for name in names:
        client.add_template(policies.load(name))
    kinds = {policies.load(n)["spec"]["crd"]["spec"]["names"]["kind"]
             for n in names}
    for kind, cname, params in GENERAL_CONSTRAINTS + PSP_CONSTRAINTS:
        if kind in kinds:
            client.add_constraint({
                "apiVersion": "constraints.gatekeeper.sh/v1beta1",
                "kind": kind, "metadata": {"name": cname},
                "spec": ({"parameters": params} if params else {})})
    if variant.endswith("+inv"):
        for o in corpus(root, 2000):
            client.add_data(o)
    return drv, client


def run(variant: str, n: int, device: str, root: str, profile: bool,
        gc_clock: GcClock) -> dict:
    t0 = time.perf_counter()
    drv, client = client_for(variant, device, root)
    setup_s = time.perf_counter() - t0
    objs = corpus(root, n)
    t0 = time.perf_counter()
    client.review_batch(corpus(root, 512))
    warm_s = time.perf_counter() - t0
    gc_clock.read()
    prof = cProfile.Profile() if profile else None
    t0 = time.perf_counter()
    if prof:
        prof.enable()
    got = client.review_batch(objs)
    if prof:
        prof.disable()
    first_s = time.perf_counter() - t0
    templates = len(drv._programs) + len(getattr(drv, "_join_progs", {}))
    out = {"variant": variant, "n": n, "templates": templates,
           "results": sum(len(r.results()) for r in got),
           "vocab": len(drv.strtab), "setup_s": setup_s,
           "warm512_s": warm_s, "first_s": first_s,
           "first": gc_clock.read(), "profiled": bool(prof)}
    if prof:
        for key in ("cumulative", "tottime"):
            buf = io.StringIO()
            pstats.Stats(prof, stream=buf).sort_stats(key).print_stats(40)
            print(f"--- {variant}: cProfile of the first {n} batch, by {key}")
            print(buf.getvalue())
        return out
    t0 = time.perf_counter()
    again = client.review_batch(objs)
    out["steady_s"] = time.perf_counter() - t0
    out["steady"] = gc_clock.read()
    out["vocab_after_steady"] = len(drv.strtab)
    if out["results"] != sum(len(r.results()) for r in again):
        raise SystemExit(f"{variant}: the repeated batch differs")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--variants", default="pr1,all23,all23+inv")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    variants = args.variants.split(",")
    runs = [(v, False) for v in variants]
    if args.profile:
        runs.append((variants[-1], True))
    gc_clock = GcClock()
    for v, profile in runs:
        rec = run(v, args.n, args.device, root, profile, gc_clock)
        rec["root"] = os.path.relpath(root, HERE)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
