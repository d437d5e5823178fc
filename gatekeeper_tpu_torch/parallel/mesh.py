"""Device mesh construction and audit-sweep sharding.

The audit cross-product (objects × constraints, SURVEY.md §2.5) shards
over a 2-D mesh:

  * "data"  — the object/review axis (N): each device evaluates a
    contiguous block of the cluster inventory. Pure data parallelism: no
    cross-device traffic during evaluation.
  * "model" — the constraint axis (C): parameter tensors split across
    devices when constraint sets are large.

A mesh here is a [data, model] grid of `torch.device`s, and it may
repeat a device: a repeated entry is one VIRTUAL shard, the role an XLA
virtual device plays for the JAX package (its tests run on 8 virtual CPU
devices). Virtual shards run every shard's kernels with their global
row offsets and masks on one card or one CPU, which is how the mesh path
is tested and measured where a host has one card.

There is no shard_map: the evaluator (ir/evaltorch.py) and the audit
step (parallel/collectives.py) iterate the shards explicitly, each
shard's launches on its own device (`on_device`). A placement is a
`Sharded`: one tensor per mesh position, split over the axis its `spec`
names per dimension (PartitionSpec's role) or replicated.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from ..ir.carry import to_tensor


class Mesh:
    """A [data, model] grid of torch devices, data-major."""

    def __init__(self, grid: list):
        self.devices = [list(row) for row in grid]
        self.shape = {"data": len(self.devices),
                      "model": len(self.devices[0])}

    def device(self, d: int, m: int = 0) -> torch.device:
        return self.devices[d][m]

    @property
    def flat(self) -> list:
        return [dev for row in self.devices for dev in row]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, "
                f"model={self.shape['model']}, devices="
                f"{[str(d) for d in self.flat]})")


def visible_devices(device="cuda") -> list:
    """The real devices of a type this process sees: `cuda` gives
    cuda:0..count-1 (none without a card), `cpu` gives one cpu. The one
    place that lists devices (tests substitute a list of virtual
    shards)."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            return []
        return [torch.device("cuda", k)
                for k in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def _indexed(dev: torch.device) -> torch.device:
    """`cuda` as the card it means (the current one), so that a mesh
    names each card one way."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices=None, data: Optional[int] = None,
              model: int = 1) -> Mesh:
    """Mesh over the given devices (default: every visible card),
    data-major. A device may appear more than once: each entry is one
    shard, and repeats are virtual shards of one device.

    Default: all devices on the data axis (objects), model=1. For very
    large constraint sets pass model>1 to shard parameters too.
    """
    devices = [_indexed(torch.device(d)) for d in
               (devices if devices is not None else visible_devices())]
    n = len(devices)
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    return Mesh([devices[d * model:(d + 1) * model] for d in range(data)])


def on_device(dev: torch.device):
    """The context a shard's launches run in: its card current (the
    ctypes kernels and Triton launch on the current device, on its
    current stream); nothing for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class Sharded:
    """One array placed over a mesh. `spec` gives, per dimension, the
    mesh axis that splits it ("data" or "model") or None; `blocks[(d,
    m)]` is the block on mesh device (d, m). Positions on one device
    share one tensor where their blocks are equal (a replicated leaf is
    one tensor per distinct device)."""

    def __init__(self, mesh: Mesh, spec: tuple, shape: tuple, dtype,
                 blocks: dict):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shape = tuple(shape)
        self.dtype = dtype
        self.blocks = blocks

    def block(self, d: int = 0, m: int = 0) -> torch.Tensor:
        return self.blocks[(d, m)]


def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def pad_batch(feats: dict, n_mult: int) -> tuple[dict, int]:
    """Pad every [N, ...] feature array so N divides the data axis."""
    out = {}
    n_old = None
    for slot, arrs in feats.items():
        out[slot] = {}
        for name, a in arrs.items():
            n_old = a.shape[0]
            n_new = _pad_to(n_old, n_mult)
            if n_new != n_old:
                pad = [(0, n_new - n_old)] + [(0, 0)] * (a.ndim - 1)
                a = np.pad(a, pad)
            out[slot][name] = a
    return out, (n_old if n_old is not None else 0)


def _place(a, dev: torch.device) -> torch.Tensor:
    """A host array or a tensor on `dev` (a CPU tensor of a contiguous
    host array shares its memory)."""
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return to_tensor(a, dev)


def place(a, mesh: Mesh, axis: Optional[str]) -> Sharded:
    """Place one array over `mesh`: its leading dimension split into
    contiguous blocks over `axis` ("data" or "model"; block k on every
    device of mesh row or column k), or replicated (None, and 0-d
    arrays). A Sharded with this placement passes through."""
    if isinstance(a, Sharded):
        if a.mesh is mesh and (a.spec[:1] == (axis,) or
                               (axis is None and not any(a.spec))):
            return a
        raise ValueError(f"already placed as {a.spec} on {a.mesh}")
    shape = tuple(a.shape) if hasattr(a, "shape") else ()
    nd, nm = mesh.shape["data"], mesh.shape["model"]
    if axis is None or not shape:
        spec = (None,) * len(shape)
        by_dev: dict = {}
        blocks = {}
        for d in range(nd):
            for m in range(nm):
                dev = mesh.device(d, m)
                t = by_dev.get(dev)
                if t is None:
                    t = by_dev[dev] = _place(a, dev)
                blocks[(d, m)] = t
        return Sharded(mesh, spec, shape, blocks[(0, 0)].dtype, blocks)
    k = mesh.shape[axis]
    if shape[0] % k:
        raise ValueError(f"leading dim {shape[0]} not divisible by "
                         f"{axis}={k}")
    step = shape[0] // k
    spec = (axis,) + (None,) * (len(shape) - 1)
    blocks = {}
    for d in range(nd):
        for m in range(nm):
            i = d if axis == "data" else m
            dev = mesh.device(d, m)
            # a block repeated on one device (the other axis's positions
            # of a virtual shard) is one tensor
            prev = blocks.get((d, m - 1)) if axis == "data" and m else \
                blocks.get((d - 1, m)) if axis == "model" and d else None
            if prev is not None and prev.device == dev:
                blocks[(d, m)] = prev
                continue
            blocks[(d, m)] = _place(a[i * step:(i + 1) * step], dev)
    return Sharded(mesh, spec, shape, blocks[(0, 0)].dtype, blocks)


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_features(feats: dict, mesh: Mesh) -> dict:
    """Place feature arrays sharded on the data axis (leading N dim)."""
    return _tree(lambda a: place(a, mesh, "data"), feats)


def shard_params(params: dict, mesh: Mesh, shard_c: bool = False) -> dict:
    """Constraint tensors: replicated by default; sharded over "model"
    when the constraint set is large."""
    return _tree(lambda a: place(a, mesh, "model" if shard_c else None),
                 params)


def replicate(x, mesh: Mesh):
    return _tree(lambda a: place(a, mesh, None), x)


def block_tree(tree, d: int, m: int = 0):
    """The tree of blocks on mesh device (d, m) of a tree of Sharded
    leaves."""
    return _tree(lambda s: s.block(d, m), tree)
