"""Central registry of trace-stage and sweep-phase names.

Every name passed to a span recorder (``Trace.span``/``add_span``/
``add_phase``, the frontends' ``observe_stage``/``stage_hook``, the
driver's ``PhaseTimers`` phases) must be declared here — the
``gatekeeper_tpu_stage_duration_seconds{stage}`` label set is BOUNDED
by this table, dashboards join against it, and the README stage table
renders from it (``python -m tools.gklint --stages-md``; the
``tests/test_gklint.py`` sync test keeps README honest).

The gklint ``jit-stage`` checker enforces membership statically: a
stage literal not in this table fails CI, so a typo'd span name can't
mint an unbounded metric series or a dashboard hole.

This module must stay dependency-free (no jax, no package siblings):
the linter loads it by file path, outside the package import graph.
"""

from __future__ import annotations

# name -> (plane hint, one-line description). The plane hint is
# documentation only — report_stage labels the plane at runtime.
STAGES: dict[str, tuple[str, str]] = {
    # admission plane ------------------------------------------------
    "frontend_parse": (
        "admission", "HTTP read + JSON parse on the frontend process"),
    "backplane_forward": (
        "admission", "one-way hop: frontend enqueue to engine frame "
        "receipt over the backplane socket"),
    "ring_write": (
        "admission", "frontend copy of the review into its shm "
        "request ring"),
    "ring_read": (
        "admission", "engine-side zero-copy JSON decode off the "
        "mapped request ring"),
    "engine_queue": (
        "admission", "frame receipt to evaluation-pool pickup inside "
        "the engine"),
    "batch_seal": (
        "admission", "micro-batch collection window: submit to "
        "evaluation start"),
    "evaluate": (
        "both", "batched driver evaluation (admission) or the audit "
        "sweep's aggregate evaluation wall"),
    "cache_hit": (
        "admission", "decision-cache lookup that answered the request"),
    "serialize": (
        "admission", "AdmissionReview response envelope encoding"),
    "respond": (
        "admission", "verdict bytes written back over the backplane"),
    # audit plane ----------------------------------------------------
    "list_delta_apply": (
        "audit", "inventory list / watch-delta application ahead of "
        "the sweep"),
    "encode": (
        "audit", "review encoding into the dense feature tensors"),
    "delta_serve": (
        "audit", "incremental encoded-row cache serve (dirty-row "
        "re-encode)"),
    "device_sweep": (
        "audit", "K2 + K1 launches on the card + the wait for each "
        "slab's pairs"),
    "materialize": (
        "audit", "violation message materialization from firing "
        "(row, constraint) pairs"),
    "interp_eval": (
        "audit", "interpreter-path evaluation (kinds without device "
        "programs)"),
    "compile": (
        "audit", "K2 variant acquisition (program store load or "
        "Triton compile)"),
    "evaluate_other": (
        "audit", "evaluation wall not covered by an instrumented "
        "phase"),
    "status_write": (
        "audit", "streamed per-kind constraint-status write (writer "
        "thread, overlaps the sweep)"),
    "status_writes": (
        "audit", "post-sweep constraint-status write pass"),
    "status_write_stream": (
        "audit", "streamed status-write wall attributed to the sweep "
        "that overlapped it"),
    "shard_sweeps": (
        "audit", "sharded plane: per-shard slice sweep dispatch + "
        "composition into one audit round (leader side)"),
    # fleet-scan plane -----------------------------------------------
    "scan_load": (
        "scan", "fleet scan: feeder wait on the loader-process queue "
        "(parse + envelope synthesis off the hot path)"),
    "scan_dedupe": (
        "scan", "fleet scan: content-hash dedupe pass over one loader "
        "chunk"),
    "scan_feed": (
        "scan", "fleet scan: bulk-batch round trip — begin to verdict "
        "receipt on the wire tier"),
    "scan_report": (
        "scan", "fleet scan: verdict rejoin + streaming JSONL record "
        "emission for one bulk batch"),
}

STAGE_NAMES = frozenset(STAGES)


def stages_markdown() -> str:
    """The README stage table, rendered from this registry."""
    out = ["| stage | plane | what it measures |",
           "| --- | --- | --- |"]
    for name in sorted(STAGES):
        plane, desc = STAGES[name]
        out.append(f"| `{name}` | {plane} | {desc} |")
    return "\n".join(out)
