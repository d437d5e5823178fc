"""Explicit-collective audit aggregation over the mesh.

Where the JAX package spells its audit step out with shard_map, this
module iterates the shards of a parallel/mesh.py Mesh explicitly:

  * each shard's epilogue is one K6 launch (kernels/shard_counts.py) on
    its own device: its verdict words masked to the valid rows, written
    as bool into its block of one [N, C] fires tensor on the mesh's first
    device (the verdict gather: the host materializes messages once),
    and its column counts added into its device's partial, zeroed once a
    step (the shards one device holds sum into one tensor);
  * per-constraint violation counts: the per-device partials summed on
    the mesh's first device (`torch.cuda.comm.reduce_add`: the psum's
    cross-card half, a collective and not a kernel; on one card, with
    virtual shards, it does not run). A shard on another device writes
    a local block, which the step copies across.

The counterpart of the reference's single-goroutine audit aggregation
(pkg/audit/manager.go:337-385 getUpdateListsFromAudit...).
"""

from __future__ import annotations

import torch

from ..kernels.clause import feat_rows, param_c
from ..kernels.shard_counts import shard_counts
from .mesh import (
    Mesh,
    Sharded,
    block_tree,
    on_device,
    place,
    replicate,
    shard_features,
)


def _split_model(params: dict, mesh: Mesh) -> dict:
    """Constraint tensors split on C over "model" (the step's placement,
    whatever shard_params chose): a replicated placement is cut into the
    column blocks in place (views of each device's copy)."""
    nm = mesh.shape["model"]

    def split(a):
        if not isinstance(a, Sharded) or a.spec[:1] == ("model",):
            return place(a, mesh, "model")
        if a.shape[0] % nm:
            raise ValueError(f"leading dim {a.shape[0]} not divisible by "
                             f"model={nm}")
        step = a.shape[0] // nm
        blocks = {(d, m): t[m * step:(m + 1) * step]
                  for (d, m), t in a.blocks.items()}
        return Sharded(mesh, ("model",) + a.spec[1:], a.shape, a.dtype,
                       blocks)

    return {slot: {nm_: split(a) for nm_, a in arrs.items()}
            for slot, arrs in params.items()}


def _sum_over_devices(parts: list, dest: torch.device) -> torch.Tensor:
    """The psum's cross-card half: one partial per device, summed on
    `dest` (no work when one device holds every shard)."""
    if len(parts) == 1:
        return parts[0].to(dest)
    return torch.cuda.comm.reduce_add(parts, destination=dest.index)


def make_audit_step(eval_fn, mesh: Mesh):
    """Build the sharded audit step: feats split on "data", params on
    "model", the match table and derived vocab columns replicated; returns
    step(feats, params, table, derived, n_valid) -> (fires [N, C] bool on
    the mesh's first device, counts [C] int32 there), rows at or past
    n_valid masked in both.

    eval_fn(feats, params, table, derived) -> packed verdict words
    [N_local, ceil(C_local / 32)] int32 on the inputs' device
    (CompiledTemplate.words) must be pure; it runs once per mesh
    position, on that position's device."""
    nd, nm = mesh.shape["data"], mesh.shape["model"]
    first = mesh.device(0, 0)

    def step(feats, params, table, derived, n_valid):
        n_valid = int(n_valid)
        feats = shard_features(feats, mesh)
        params = _split_model(params, mesh)
        table = replicate(table, mesh)
        derived = replicate(derived or {}, mesh)
        n, c = feat_rows(feats), param_c(params)
        n_loc, c_loc = n // nd, c // nm
        # the shards' blocks tile fires exactly (shard_features and
        # _split_model raise on a shape that does not divide), and each
        # block is written whole by its shard's K6 launch
        fires = torch.empty((n, c), dtype=torch.bool, device=first)
        partial: dict = {}  # device -> int32 [c], zeroed once a step
        for m in range(nm):
            cols = slice(m * c_loc, (m + 1) * c_loc)
            for d in range(nd):
                dev = mesh.device(d, m)
                rows = slice(d * n_loc, (d + 1) * n_loc)
                # this shard covers global rows [d*n_loc, (d+1)*n_loc)
                r_end = max(0, min(n_loc, n_valid - d * n_loc))
                with on_device(dev):
                    words = eval_fn(block_tree(feats, d, m),
                                    block_tree(params, d, m),
                                    table.block(d, m),
                                    block_tree(derived, d, m))
                    if dev not in partial:
                        partial[dev] = torch.zeros((c,), dtype=torch.int32,
                                                   device=dev)
                    block = fires[rows, cols] if dev == first else \
                        torch.empty((n_loc, c_loc), dtype=torch.bool,
                                    device=dev)
                    shard_counts(words, 0, r_end, c_loc, block,
                                 partial[dev][cols])
                if dev != first:
                    fires[rows, cols] = block.to(first)
        return fires, _sum_over_devices(list(partial.values()), first)

    return step
