"""Consistent-hash shard map for the sharded audit inventory plane.

The audit inventory is partitioned by (GVK, namespace): every object of
one kind in one namespace (namespace "" for cluster-scoped objects)
lands on exactly one audit shard, which owns that slice end to end —
its watch deltas, encoded feature rows, delta cache and incremental
sweep state. The map must be

  * deterministic ACROSS PROCESSES: the leader routes inventory ops and
    every shard engine filters its own review set from the same key,
    so both sides must compute the same owner. Python's builtin
    ``hash()`` is salted per process and therefore banned here —
    positions come from blake2b over the canonical key string.
  * stable under resizing: growing 2 -> 4 shards must move ~1/2 of the
    keys (the consistent-hashing contract), not rehash the world. Each
    shard projects ``vnodes`` virtual points onto a 64-bit ring and a
    key belongs to the first point clockwise from its own position.

The leader owns ONE ShardMap instance per topology and bumps
``version`` on every (re)assignment so the rebalance metrics series
(`gatekeeper_tpu_audit_shard_map_version`,
`gatekeeper_tpu_audit_shard_rebalanced_total`) can tell a settled map
from one that is still churning.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, Optional

GVK = tuple  # (group, version, kind) — control/kube.py convention


def _point(token: str) -> int:
    """64-bit ring position of a token, stable across processes."""
    return int.from_bytes(
        hashlib.blake2b(token.encode("utf-8"), digest_size=8).digest(),
        "big")


def partition_key(gvk: GVK, namespace: str = "") -> str:
    """Canonical partition-key string for (GVK, namespace). Cluster-
    scoped objects use namespace "" — one owner per cluster-scoped
    kind, by design (the partition unit is (GVK, namespace))."""
    group, version, kind = gvk
    return f"{group or ''}|{version or ''}|{kind or ''}|{namespace or ''}"


class ShardMap:
    """The ring: `shards` shards x `vnodes` virtual points each."""

    def __init__(self, shards: int, vnodes: int = 64):
        if shards < 1:
            raise ValueError("shard count must be >= 1")
        self.shards = int(shards)
        self.vnodes = int(vnodes)
        self.version = 1
        self._points: list[int] = []
        self._owners: list[int] = []
        for k in range(self.shards):
            for v in range(self.vnodes):
                self._points.append(_point(f"audit-shard:{k}:{v}"))
                self._owners.append(k)
        order = sorted(range(len(self._points)),
                       key=lambda i: self._points[i])
        self._points = [self._points[i] for i in order]
        self._owners = [self._owners[i] for i in order]

    def owner(self, gvk: GVK, namespace: str = "") -> int:
        """Shard index owning (GVK, namespace)."""
        if self.shards == 1:
            return 0
        h = _point(partition_key(gvk, namespace))
        i = bisect.bisect_right(self._points, h)
        if i == len(self._points):
            i = 0  # wrap: the ring is circular
        return self._owners[i]

    def owner_of_obj(self, gvk: GVK, obj: dict) -> int:
        ns = ((obj or {}).get("metadata") or {}).get("namespace") or ""
        return self.owner(gvk, ns)

    def owns(self, shard: int, gvk: GVK, namespace: str = "") -> bool:
        return self.owner(gvk, namespace) == int(shard)

    # ------------------------------------------------------- rebalancing

    def rebalance(self, shards: int,
                  keys: Optional[Iterable[tuple]] = None) -> dict:
        """Re-assign the ring for a new shard count. Returns
        {"moved": n, "total": n, "fraction": f} over `keys` (an
        iterable of (gvk, namespace) partition keys; empty -> zeros) so
        the caller can export how much of the inventory the resize
        displaced — ~|new-old|/max(new,old) for a healthy ring, ~1.0
        for a broken (mod-N style) one. Bumps `version` even when no
        key moved: the assignment epoch changed either way."""
        old = ShardMap(self.shards, self.vnodes)
        version = self.version
        self.__init__(shards, self.vnodes)  # rebuild the ring in place
        self.version = version + 1
        moved = total = 0
        for gvk, ns in keys or ():
            total += 1
            if old.owner(gvk, ns) != self.owner(gvk, ns):
                moved += 1
        return {"moved": moved, "total": total,
                "fraction": (moved / total) if total else 0.0}

    def assignment_counts(self, keys: Iterable[tuple]) -> list[int]:
        """Objects-per-shard histogram over (gvk, namespace) keys — the
        ownership gauge's source (skew is the thing to watch: one hot
        namespace pins its whole slice to one shard)."""
        counts = [0] * self.shards
        for gvk, ns in keys:
            counts[self.owner(gvk, ns)] += 1
        return counts
