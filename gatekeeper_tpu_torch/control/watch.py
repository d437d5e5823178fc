"""Dynamic watch manager.

Counterpart of the reference pkg/watch + the dynamiccache fork: ref-counted
per-GVK watches shared by registrars (manager.go:139-224), a central
fan-out delivering events to every interested registrar's queue
(manager.go:287-349), replay of already-cached objects to late-joining
registrars (replay.go), and removable watches — the whole reason the
reference forks controller-runtime's cache (GetInformerNonBlocking +
Remove) is to tear informers down dynamically, which here is just
cancelling a subscription.
"""

from __future__ import annotations

import copy
import queue
import threading
from typing import Callable, Optional

from .kube import GVK, WatchEvent


class WatchError(Exception):
    pass


class Registrar:
    """A controller's handle on the watch manager. Events for any GVK the
    registrar watches land in its queue as (event_type, object)."""

    def __init__(self, name: str, manager: "WatchManager"):
        self.name = name
        self.manager = manager
        self.events: "queue.Queue[WatchEvent]" = queue.Queue()
        self.gvks: set[GVK] = set()

    def add_watch(self, gvk: GVK) -> None:
        self.manager._add_watch(self, tuple(gvk))

    def remove_watch(self, gvk: GVK) -> None:
        self.manager._remove_watch(self, tuple(gvk))

    def replace_watches(self, gvks: list[GVK]) -> None:
        """Atomically swap the watched set (reference registrar
        ReplaceWatch, used by the config controller)."""
        want = {tuple(g) for g in gvks}
        for g in list(self.gvks - want):
            self.remove_watch(g)
        for g in sorted(want - self.gvks):
            self.add_watch(g)


class _WatchRecord:
    def __init__(self):
        self.registrars: set[Registrar] = set()
        self.cancel: Optional[Callable[[], None]] = None
        self.cache: dict[tuple, dict] = {}  # (ns, name) -> obj


class WatchManager:
    """Ref-counted dynamic watches over a KubeClient."""

    def __init__(self, kube):
        self.kube = kube
        self._lock = threading.RLock()
        self._records: dict[GVK, _WatchRecord] = {}
        self.paused = False

    # ----------------------------------------------------------- intents

    def watched_gvks(self) -> list[GVK]:
        with self._lock:
            return sorted(self._records)

    def is_watched(self, gvk: GVK) -> bool:
        with self._lock:
            return tuple(gvk) in self._records

    def _add_watch(self, registrar: Registrar, gvk: GVK) -> None:
        with self._lock:
            rec = self._records.get(gvk)
            if rec is None:
                rec = _WatchRecord()
                self._records[gvk] = rec
                # subscribe BEFORE opening the kube watch: the initial
                # list-events fan out synchronously and must reach this
                # first registrar, not just the cache
                rec.registrars.add(registrar)
                registrar.gvks.add(gvk)

                def deliver(event: WatchEvent, _gvk=gvk, _rec=rec):
                    self._fanout(_gvk, _rec, event)

                rec.cancel = self.kube.watch(gvk, deliver, send_initial=True)
            elif registrar not in rec.registrars:
                # replay the cache so late joiners see existing objects
                # (reference watch/replay.go:136-183)
                for obj in sorted(rec.cache.values(),
                                  key=lambda o: _okey(o)):
                    registrar.events.put(WatchEvent("ADDED", obj))
            rec.registrars.add(registrar)
            registrar.gvks.add(gvk)

    def _remove_watch(self, registrar: Registrar, gvk: GVK) -> None:
        with self._lock:
            rec = self._records.get(gvk)
            registrar.gvks.discard(gvk)
            if rec is None:
                return
            rec.registrars.discard(registrar)
            if not rec.registrars:
                if rec.cancel:
                    rec.cancel()
                del self._records[gvk]

    def _fanout(self, gvk: GVK, rec: _WatchRecord, event: WatchEvent) -> None:
        with self._lock:
            key = _okey(event.object)
            if event.type == "DELETED":
                rec.cache.pop(key, None)
            else:
                rec.cache[key] = event.object
            if self.paused:
                return
            targets = list(rec.registrars)
        for r in targets:
            r.events.put(event)

    def cached_get(self, gvk: GVK, name: str,
                   namespace: str = "") -> Optional[dict]:
        """Latest cached object for (gvk, ns, name) — the informer-cache
        read the reference reconcilers use. None when the object is gone
        from the cache (at least as new as any drained event; _fanout pops
        it on DELETED) or the GVK is no longer watched."""
        with self._lock:
            rec = self._records.get(tuple(gvk))
            if rec is None:
                return None
            obj = rec.cache.get((namespace or "", name))
            # deep copy: callers mutate (status writes) and the cache entry
            # is shared with late-joiner replay and other registrars
            return copy.deepcopy(obj) if obj is not None else None

    def cached_objects(self, gvk: GVK) -> list[dict]:
        with self._lock:
            rec = self._records.get(tuple(gvk))
            if rec is None:
                return []
            return [rec.cache[k] for k in sorted(rec.cache)]

    def registrar(self, name: str) -> Registrar:
        return Registrar(name, self)

    def stop(self) -> None:
        with self._lock:
            for rec in self._records.values():
                if rec.cancel:
                    rec.cancel()
            self._records.clear()


def _okey(obj: dict) -> tuple:
    meta = obj.get("metadata") or {}
    return (meta.get("namespace") or "", meta.get("name") or "")
