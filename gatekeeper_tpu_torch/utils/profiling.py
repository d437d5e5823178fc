"""Profiling + compiler introspection.

The reference exposes pprof endpoints through controller-runtime; the
CUDA analogs are (a) the device program itself — render the Triton
source generated for any compiled template, or the PTX its compile
emitted, to see exactly what the card executes — and (b)
torch.profiler traces viewable in TensorBoard/Perfetto for device
timelines. Host-side audit phases get a lightweight timer registry that
feeds the metrics exposition.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional


def compiled_hlo(ct, feats, params, table, derived=None,
                 stage: str = "hlo") -> str:
    """The device program for one template's dense sweep: K2, the
    Triton kernel generated for these inputs (kernels/clause_triton).
    stage: "jaxpr" | "hlo" (the generated Triton source; the stage names
    are the JAX package's) | "optimized" (the PTX Triton compiled for
    these inputs, launching the variant once if it has not run; CUDA
    tensors only)."""
    from ..kernels import clause_triton

    derived = derived or {}
    if stage == "optimized":
        if table.device.type != "cuda":
            raise ValueError("compiled_hlo(stage='optimized') compiles K2 "
                             f"on the card; the inputs are on {table.device}")
        return clause_triton.compiled_kernel(
            ct.plans, feats, params, table, derived, ct._kernels).asm["ptx"]
    return clause_triton.generate(ct.plans, feats, params, table,
                                  derived)[0]


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace (TensorBoard/Perfetto) around a block; the
    Chrome trace (`<worker>.<ms>.pt.trace.json`) is written into
    `log_dir` when the block ends, and the profiler is yielded (its
    key_averages() sums device time by kernel):

        with device_trace("/tmp/gk-trace"):
            client.audit()
    """
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class PhaseTimers:
    """Named wall-clock phase accumulators (audit: encode/device_sweep/
    materialize/...), exposed via control.metrics + the trace layer.

    The driver's audit internals add() into the process-global timers()
    instance; the audit manager snapshots before/after a sweep and
    diffs, turning the per-sweep phase durations into trace spans and
    per-stage histograms — the attribution PAPER.md's per-package stats
    reporters provide in the reference line."""

    def __init__(self):
        import threading
        self._lock = threading.Lock()
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.add(name, time.monotonic() - t0)

    def add(self, name: str, seconds: float, n: int = 1) -> None:
        """Accumulate an externally-timed interval (slab pipelines time
        device-wait and materialize with two stopwatches inside one
        loop — a context manager per slab would mis-nest)."""
        with self._lock:
            self.totals[name] = self.totals.get(name, 0.0) + seconds
            self.counts[name] = self.counts.get(name, 0) + n

    def snapshot(self) -> dict[str, tuple[float, int]]:
        with self._lock:
            return {k: (self.totals[k], self.counts[k])
                    for k in self.totals}

    @staticmethod
    def diff(before: dict, after: dict) -> dict[str, float]:
        """Per-phase seconds accumulated between two snapshots."""
        out = {}
        for name, (total, _n) in after.items():
            delta = total - before.get(name, (0.0, 0))[0]
            if delta > 1e-9:
                out[name] = delta
        return out


_timers: Optional[PhaseTimers] = None


def timers() -> PhaseTimers:
    global _timers
    if _timers is None:
        _timers = PhaseTimers()
    return _timers
