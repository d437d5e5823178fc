"""Audit manager: periodic full-cluster sweeps, optionally incremental.

Counterpart of the reference pkg/audit/manager.go, re-designed around the
batched evaluator. The reference's hot loop lists every object of every
listable GVK and calls Review one object at a time (manager.go:250-271);
here the whole inventory goes through the driver's vectorized audit in one
batched sweep (audit-from-cache) or per-GVK batches (discovery mode), then
violations are aggregated per constraint (manager.go:337-385) and written
to constraint status with the violations cap, message truncation, and
conflict-retry loop (manager.go:428-574).

Incremental mode (--audit-incremental) replaces the per-sweep O(cluster)
re-list + re-encode with a PERSISTENT encoded inventory: a tracked mirror
of every auditable object keyed (uid, resourceVersion), fed by streaming
watches, applied to the driver's synced inventory each sweep so the
driver's journaled caches patch only the dirty rows (feature tensors,
match masks, and device buffers stay resident between sweeps). Watch gaps
fall back to a resourceVersion-diff against a paged re-list; every
--audit-full-resync-every sweeps the whole inventory re-encodes from
scratch as a self-healing backstop. Constraint-status writes are also
delta'd: a constraint whose violation set did not change since its last
written status is skipped entirely.
"""

from __future__ import annotations

import heapq
import json
import threading
import time
from typing import Any, Callable, Optional

from ..client import Client, Result
from ..utils import profiling
from ..utils.values import thaw
from . import metrics
from . import trace as gtrace
from .kube import GVK, KubeError, NotFound, ScopedKube, WatchEvent
from .logging import logger
from .util import prune_stale_by_pod

log = logger("audit")

DEFAULT_AUDIT_INTERVAL = 60  # seconds (reference manager.go:36,41)
DEFAULT_CONSTRAINT_VIOLATIONS_LIMIT = 20  # manager.go:37,42
DEFAULT_FULL_RESYNC_EVERY = 20  # incremental sweeps per full re-encode
# streaming audit (--stream-audit): debounce window after the first
# buffered watch event before a flush, and the pending-event count that
# flushes early (a burst must not wait out the window event by event)
DEFAULT_STREAM_WINDOW_S = 0.025
DEFAULT_STREAM_MAX_BATCH = 512
MSG_SIZE_LIMIT = 256  # bytes (manager.go:35,437-439)
CONSTRAINT_GROUP = "constraints.gatekeeper.sh"
# the keys of a constraint's status the audit writes; a status write
# retried on a conflict overlays its own keys on the live status
# (the audit these, the controllers every other)
AUDIT_STATUS_KEYS = ("auditTimestamp", "totalViolations", "violations")

# kinds never audited (cluster plumbing the reference also skips)
_SKIP_KINDS = {"Event", "ComponentStatus", "Endpoints", "EndpointSlice",
               "Lease", "SelfSubjectReview", "TokenReview",
               "SubjectAccessReview", "CustomResourceDefinition",
               "ConstraintTemplate"}


def _auditable_gvks(kube) -> list[GVK]:
    """Discovery-driven auditable GVK set (same filter as the discovery
    sweep): listable, not control-plane plumbing, not our own CRs."""
    out = []
    for r in kube.server_preferred_resources():
        if "list" not in (r.get("verbs") or []):
            continue
        if r.get("kind") in _SKIP_KINDS:
            continue
        if r.get("group") in ("templates.gatekeeper.sh", CONSTRAINT_GROUP):
            continue
        out.append((r.get("group") or "", r.get("version") or "",
                    r.get("kind") or ""))
    # Namespaces first: their labels feed namespaceSelector matching for
    # everything else, so the initial encode must see them early
    out.sort(key=lambda g: (g[2] != "Namespace", g))
    return out


def _obj_key(gvk: GVK, obj: dict) -> tuple:
    meta = obj.get("metadata") or {}
    return (tuple(gvk), meta.get("namespace") or "", meta.get("name") or "")


def _obj_ver(obj: dict) -> tuple:
    meta = obj.get("metadata") or {}
    return (meta.get("uid"), meta.get("resourceVersion"))


class InventoryTracker:
    """Persistent encoded-inventory maintenance for the incremental audit.

    Mirrors the auditable cluster state into the policy client's synced
    inventory: per-GVK streaming watches accumulate a DIRTY MAP (latest
    event per object key — bounded by the inventory size, so an event
    burst collapses instead of queueing unboundedly), and each sweep
    applies only the delta through client.add_data/remove_data, which the
    driver's patch journal turns into in-place row patches of its cached
    feature tensors. A `(uid, resourceVersion)` state map suppresses
    no-op events and detects delete-then-recreate (same name, new uid).

    GVKs whose watch cannot be established (or that signaled a gap — a
    410 Gone the client could not bridge, an overflowed stream) fall back
    to a resourceVersion-diff against a paged re-list on every sweep
    until the watch heals.
    """

    def __init__(self, kube, opa: Client, sink=None):
        self.kube = kube
        self.opa = opa
        # where applied deltas land: the client itself by default; the
        # sharded plane can substitute a routing sink (leader apply +
        # owner-shard fan-out) without the tracker knowing about shards
        self.sink = sink if sink is not None else opa
        self._lock = threading.Lock()
        self._dirty: dict[tuple, tuple] = {}   # key -> (etype, obj)
        # streaming audit: monotonic receipt time of the OLDEST pending
        # event per dirty key (coalescing keeps the first — detection
        # latency is measured from the earliest unserved change), and
        # an observer fired (outside the lock) whenever a watch event
        # lands so the stream loop can debounce-flush instead of
        # polling. Both are no-ops until the stream loop arms them.
        self._dirty_at: dict[tuple, float] = {}
        self.track_event_times = False
        self.on_event: Optional[Callable[[], None]] = None
        self._state: dict[tuple, tuple] = {}   # key -> (uid, rv)
        self._cancels: dict[GVK, Callable[[], None]] = {}
        self._poll: set[GVK] = set()   # watchless GVKs: re-list per sweep
        self._gaps: set[GVK] = set()   # one-shot resync requests
        # last event resourceVersion per GVK: persisted in the state
        # snapshot so a restarted pod's watches RESUME from where the
        # old process stopped instead of re-listing the cluster
        self._rvs: dict[GVK, str] = {}
        # warm-restart validation gate: set once restored state has been
        # re-validated against a live list (readyz consults this); a
        # cold tracker is trivially validated
        self.validated = threading.Event()
        self.validated.set()
        self._restoring = False
        # consecutive full-resyncs a tracked GVK was absent from
        # discovery: dropping (and purging its inventory) on the FIRST
        # absence would let one flaky discovery response evict whole
        # kinds from the shared inventory
        self._gvk_missing: dict[GVK, int] = {}

    # ------------------------------------------------------------- watches

    def gvks(self) -> list[GVK]:
        with self._lock:
            return sorted(set(self._cancels) | self._poll)

    def set_gvks(self, gvks: list[GVK], resync_new: bool = True) -> None:
        """Reconcile the watched set; newly added GVKs are subscribed
        FIRST and then resynced, so no event can fall between the list
        and the watch (racing duplicates are no-op'd by the state map).
        full_resync passes resync_new=False — its own re-list seeds the
        state, so the per-GVK resync here would double-list the cluster."""
        want = {tuple(g) for g in gvks}
        with self._lock:
            have = set(self._cancels) | self._poll
            drop = have - want
            add = want - have
            for g in drop:
                cancel = self._cancels.pop(g, None)
                if cancel is not None:
                    cancel()
                self._poll.discard(g)
        for g in sorted(drop):
            self._forget_gvk(g)
        for g in sorted(add):
            self._watch_gvk(g)
            if resync_new:
                self.resync(g)

    def _watch_gvk(self, gvk: GVK, quiet: bool = False) -> bool:
        def deliver(event: WatchEvent, _gvk=gvk):
            self._note_event(_gvk, event)

        with self._lock:
            resume_rv = self._rvs.get(tuple(gvk), "")
        try:
            # resume from the last-seen RV when we have one; if the
            # server rejects it (compacted while down), on_gap schedules
            # the list-diff reconcile for anything missed
            cancel = self.kube.watch(
                gvk, deliver, send_initial=False,
                resource_version=resume_rv,
                on_gap=lambda _gvk=tuple(gvk): self.note_gap(_gvk))
        except Exception as e:
            # no stream for this GVK: degrade to per-sweep re-list diff
            # (the reference's ListerWatcher would relist on 410 Gone);
            # apply_pending retries the subscription every sweep
            if not quiet:
                log.warning("watch unavailable; falling back to "
                            "per-sweep re-list diff",
                            details={"gvk": list(gvk), "error": str(e)})
            with self._lock:
                self._poll.add(tuple(gvk))
            return False
        with self._lock:
            self._cancels[tuple(gvk)] = cancel
            self._poll.discard(tuple(gvk))
        return True

    def _note_event(self, gvk: GVK, event: WatchEvent) -> None:
        obj = event.object or {}
        key = _obj_key(gvk, obj)
        rv = (obj.get("metadata") or {}).get("resourceVersion")

        def as_int(v):
            try:
                return int(v)
            except (TypeError, ValueError):
                return None

        rv_i = as_int(rv)
        notify = None
        with self._lock:
            cur = self._dirty.get(key)
            if cur is not None and rv_i is not None:
                # never let a replayed/stale event clobber a NEWER
                # pending one for the same object (a resumed watch's
                # snapshot replay can interleave behind a live event);
                # at EQUAL rv a pending DELETED wins — a deletion
                # carries the object's last rv, so an equal-rv MODIFIED
                # is the replay of the state that deletion removed.
                # Non-numeric RVs keep last-write-wins.
                cur_i = as_int((cur[1].get("metadata") or {})
                               .get("resourceVersion"))
                if cur_i is not None and \
                        (rv_i < cur_i
                         or (rv_i == cur_i and cur[0] == "DELETED"
                             and event.type != "DELETED")):
                    return
            self._dirty[key] = (event.type, obj)
            if self.track_event_times:
                # first-event time wins: a burst coalescing onto one key
                # is still one detection, measured from its oldest event
                self._dirty_at.setdefault(key, time.monotonic())
                notify = self.on_event
            if rv_i is not None:
                # stream position for watch resume: advance-only, so a
                # stale replay cannot move the snapshot point backwards
                cur_rv = as_int(self._rvs.get(tuple(gvk)))
                if cur_rv is None or rv_i > cur_rv:
                    self._rvs[tuple(gvk)] = str(rv_i)
            elif rv:
                self._rvs[tuple(gvk)] = rv
        if notify is not None:
            # outside the lock: the stream loop's condvar takes its own
            notify()

    def note_gap(self, gvk: GVK) -> None:
        """External gap signal (watch stream lost beyond the client's
        own recovery): the next sweep re-list-diffs this GVK."""
        with self._lock:
            self._gaps.add(tuple(gvk))

    def _note_list_rv(self, gvk: GVK, objs: list) -> None:
        """Advance the per-GVK resume RV from a list's object RVs (max,
        numeric servers only — FakeKube and etcd both). Lists don't
        surface deletions, but that's safe: a deletion after the newest
        listed object has a HIGHER rv, so a watch resumed from this
        point still replays it. Watch events may already have moved the
        RV further; never move it backwards."""
        best = None
        for o in objs:
            try:
                v = int((o.get("metadata") or {}).get("resourceVersion"))
            except (TypeError, ValueError):
                continue
            if best is None or v > best:
                best = v
        if best is None:
            return
        with self._lock:
            try:
                cur = int(self._rvs.get(tuple(gvk), ""))
            except ValueError:
                cur = None
            if cur is None or best > cur:
                self._rvs[tuple(gvk)] = str(best)

    def _forget_gvk(self, gvk: GVK) -> None:
        """Remove a no-longer-audited GVK's objects from the inventory."""
        gvk = tuple(gvk)
        with self._lock:
            doomed = [k for k in self._state if k[0] == gvk]
            pend = [k for k in self._dirty if k[0] == gvk]
            for k in pend:
                del self._dirty[k]
                self._dirty_at.pop(k, None)
        for key in doomed:
            self._remove_key(key)

    def _remove_key(self, key: tuple) -> None:
        gvk, ns, name = key
        group, version, kind = gvk
        api_version = version if not group else f"{group}/{version}"
        stub = {"apiVersion": api_version, "kind": kind,
                "metadata": {"name": name}}
        if ns:
            stub["metadata"]["namespace"] = ns
        try:
            self.sink.remove_data(stub)
        except Exception as e:
            # keep the key tracked and requeue the delete: forgetting it
            # here would orphan the object in the shared inventory with
            # nothing left to retry (full resyncs only delete TRACKED
            # keys, and the data tree is never wiped by design)
            with self._lock:
                self._state.setdefault(key, (None, None))
                self._dirty.setdefault(key, ("DELETED", stub))
            log.error("inventory remove failed; delete retried next "
                      "sweep", details={"key": str(key), "error": str(e)})
            return
        with self._lock:
            self._state.pop(key, None)

    # -------------------------------------------------------------- deltas

    def resync(self, gvk: GVK) -> bool:
        """resourceVersion-diff against a fresh (paged, when the client
        pages) re-list: objects whose (uid, resourceVersion) differ from
        the tracked state become dirty, tracked objects missing from the
        list become deletes. The watch-gap / 410 Gone fallback, and the
        live-list re-validation a warm restart runs before readyz opens.
        Returns False when the list failed (the gap stays pending).

        Relist semantics: pending dirty events that PREdate the list are
        superseded by it (a stale MODIFIED for an object the list shows
        deleted must not resurrect it, and vice versa); events that land
        while the list is in flight overwrite their pre-list entry, are
        detected by identity, and win over the list."""
        gvk = tuple(gvk)
        with self._lock:
            pre = {k: v for k, v in self._dirty.items() if k[0] == gvk}
        try:
            objs = self.kube.list(gvk)
        except KubeError as e:
            log.error("resync list failed; keeping stale state this "
                      "sweep", details={"gvk": list(gvk), "error": str(e)})
            with self._lock:
                self._gaps.add(gvk)  # retry next sweep, don't lose it
            return False
        self._note_list_rv(gvk, objs)
        seen = set()
        with self._lock:
            for k, v in pre.items():
                if self._dirty.get(k) is v:  # unchanged during the list
                    del self._dirty[k]
                    # the receipt time goes with it: a later event for
                    # this key must stamp its OWN time, not revive this
                    # one via record_event's setdefault (a stale stamp
                    # collapses the debounce window and fakes a huge
                    # detection-latency tail sample)
                    self._dirty_at.pop(k, None)
            for o in objs:
                key = _obj_key(gvk, o)
                seen.add(key)
                if key in self._dirty:
                    continue  # raced in mid-list: newer than the list
                if self._state.get(key) != _obj_ver(o):
                    self._dirty[key] = ("MODIFIED", o)
            for key in self._state:
                if key[0] == gvk and key not in seen and \
                        key not in self._dirty:
                    gone = {"metadata": {"namespace": key[1] or None,
                                         "name": key[2]}}
                    self._dirty[key] = ("DELETED", gone)
        return True

    # --------------------------------------------------- warm restart

    def snapshot(self) -> dict:
        """Persistable tracker state: the tracked GVK set, per-GVK
        watch-resume resourceVersions, and the per-object (uid, rv)
        state map (the encoded-inventory index; the object BODIES live
        in the driver's data tree, snapshotted separately). The GVK set
        is derived from every source — live watches, poll fallbacks,
        resume RVs, AND the state map — so the SIGTERM drain snapshot
        (taken after stop() cancelled the watches) still records what
        to resume."""
        with self._lock:
            gvks = (set(self._cancels) | self._poll | set(self._rvs)
                    | {k[0] for k in self._state})
            return {
                "gvks": [list(g) for g in sorted(gvks)],
                "rvs": {"|".join(g): rv for g, rv in self._rvs.items()},
                "state": [[list(k[0]), k[1], k[2], v[0], v[1]]
                          for k, v in sorted(self._state.items())],
                # buffered-but-unapplied events MUST ride along: the
                # resume RVs above were already advanced by them, so a
                # resumed watch will never re-deliver them — dropping
                # them here would silently lose the delta
                "dirty": [[list(k[0]), k[1], k[2], etype, obj]
                          for k, (etype, obj)
                          in sorted(self._dirty.items())],
            }

    def restore(self, snap: dict) -> int:
        """Seed the tracker from a snapshot: state map and resume RVs
        installed, watches subscribed AT the persisted RVs — no initial
        re-list, no duplicate ADDED storm; a successfully resumed
        stream replays everything missed while down, deletes included.
        A GVK whose RV was rejected (compacted — the 410 case) or whose
        watch could not be established lands in the gap set via on_gap
        / the poll fallback, and the first sweep list-diffs exactly
        those against the live cluster. readyz stays closed until that
        first sweep validates (validated Event). Returns tracked-object
        count."""
        state: dict[tuple, tuple] = {}
        for entry in snap.get("state") or []:
            gvk, ns, name, uid, rv = entry
            state[(tuple(gvk), ns, name)] = (uid, rv)
        rvs: dict[GVK, str] = {}
        for key, rv in (snap.get("rvs") or {}).items():
            parts = tuple(key.split("|"))
            if len(parts) == 3 and rv:
                rvs[parts] = str(rv)
        gvks = [tuple(g) for g in snap.get("gvks") or []]
        # a synchronous-resume client (FakeKube) settles gap detection
        # before watch() returns, so a clean resume needs no list; an
        # ASYNC client (REST streamer: a 410 arrives a round-trip after
        # subscribe) could otherwise open readyz before the gap signal
        # lands — for those, EVERY restored GVK re-validates against a
        # live (uid, rv) list-diff on the first sweep (cheap metadata
        # compare; only changed objects re-encode)
        sync_resume = getattr(self.kube, "watch_resume_synchronous",
                              False)
        dirty: dict[tuple, tuple] = {}
        for entry in snap.get("dirty") or []:
            gvk, ns, name, etype, obj = entry
            dirty[(tuple(gvk), ns, name)] = (etype, obj)
        with self._lock:
            self._state = state
            self._rvs = rvs
            self._dirty = dirty  # un-applied events from the old process
            self._restoring = True
            for g in gvks:
                # no resume point means the watch starts blind: the
                # list-diff must reconcile missed deletes either way
                if not sync_resume or g not in rvs:
                    self._gaps.add(g)
        self.validated.clear()
        for g in gvks:
            self._watch_gvk(g, quiet=True)
        log.info("inventory tracker restored",
                 details={"objects": len(state), "gvks": len(gvks)})
        return len(state)

    def pending_count(self) -> int:
        with self._lock:
            return len(self._dirty)

    def oldest_pending_age(self) -> Optional[float]:
        """Age (seconds) of the oldest buffered-but-unapplied event, or
        None when nothing is pending. Only meaningful with
        track_event_times on (the streaming flush deadline)."""
        with self._lock:
            if not self._dirty_at:
                return None
            return time.monotonic() - min(self._dirty_at.values())

    def apply_pending(self) -> dict:
        """Drain the dirty map into the client's synced inventory.
        Returns {"dirty": applied-change count, "total": tracked size,
        "event_ts": receipt times of the drained events (streaming mode
        only — the detection-latency clock starts there)}."""
        with self._lock:
            polls = sorted(self._poll)
            gaps = sorted(self._gaps | self._poll)
            self._gaps.clear()
        for g in polls:
            # retry the stream each sweep (quietly) so a transient blip
            # at subscribe time does not pin the GVK to O(cluster)
            # re-lists forever; the resync below bridges the gap up to
            # the moment the new watch attached
            self._watch_gvk(g, quiet=True)
        resyncs_ok = True
        for g in gaps:
            resyncs_ok = self.resync(g) and resyncs_ok
        if self._restoring and resyncs_ok:
            # restored state is now re-validated against live lists:
            # open the readyz gate
            self._restoring = False
            self.validated.set()
        with self._lock:
            drained = self._dirty
            self._dirty = {}
            # event receipt times ride out with the drain; anything
            # without a live dirty entry (superseded by a relist, GVK
            # dropped) is pruned so the map cannot leak
            event_ts = [self._dirty_at.pop(k) for k in drained
                        if k in self._dirty_at]
            self._dirty_at = {k: t for k, t in self._dirty_at.items()
                              if k in self._dirty}
        applied = 0
        for key, (etype, obj) in sorted(drained.items()):
            if etype == "DELETED":
                if key in self._state:
                    self._remove_key(key)
                    applied += 1
                continue
            ver = _obj_ver(obj)
            if self._state.get(key) == ver:
                continue  # no-op event (or our own resync echo)
            try:
                self.sink.add_data(obj)
            except Exception as e:
                # requeue so the NEXT sweep retries — dropping the
                # drained entry would silently lose the delta until the
                # full-resync backstop
                with self._lock:
                    self._dirty.setdefault(key, (etype, obj))
                log.error("inventory add failed; object retried next "
                          "sweep", details={"key": str(key),
                                            "error": str(e)})
                continue
            with self._lock:
                self._state[key] = ver
            applied += 1
        with self._lock:
            total = len(self._state)
        return {"dirty": applied, "total": total, "event_ts": event_ts}

    def full_resync(self, gvks: list[GVK]) -> dict:
        """From-scratch re-encode: re-list every auditable GVK (in the
        given order — Namespaces first, so selector lookups resolve as
        the rebuild progresses), overwrite every tracked object in
        place, and delete whatever the tracker knew that no list
        returned. The synced inventory is NOT wiped: other writers
        co-own it (the config controller's syncOnly kinds feed the same
        tree), and admission served from this client must never observe
        a mid-rebuild empty inventory. Divergence in anything the
        tracker tracks is healed (the --audit-full-resync-every
        backstop); foreign inventory data is left alone by design.

        A tracked GVK absent from `gvks` is only dropped after TWO
        consecutive absences: discovery is served per API group and one
        transient group failure must not purge whole kinds from the
        shared inventory for the next resync period."""
        want = {tuple(g) for g in gvks}
        keep: list[GVK] = [tuple(g) for g in gvks]
        for g in self.gvks():
            if g in want:
                continue
            misses = self._gvk_missing.get(g, 0) + 1
            if misses < 2:
                self._gvk_missing[g] = misses
                keep.append(g)  # benefit of the doubt this round
            else:
                self._gvk_missing.pop(g, None)
        for g in want:
            self._gvk_missing.pop(g, None)
        gvks = keep
        self.set_gvks(gvks, resync_new=False)
        with self._lock:
            old_state = dict(self._state)
            self._gaps.clear()
        tracked = set(self.gvks())
        state: dict[tuple, tuple] = {}
        n = 0
        for gvk in gvks:
            gvk = tuple(gvk)
            if gvk not in tracked:
                continue
            with self._lock:
                pre = {k: v for k, v in self._dirty.items()
                       if k[0] == gvk}
            try:
                objs = self.kube.list(gvk)
            except KubeError:
                # no list, no delete detection: keep this GVK's old
                # state so its objects are not orphaned in the inventory
                # (its PENDING events also survive — clearing them
                # before a successful list would lose mutations the
                # watch stream has already moved past)
                state.update({k: v for k, v in old_state.items()
                              if k[0] == gvk})
                continue
            self._note_list_rv(gvk, objs)
            with self._lock:
                # the list supersedes this GVK's pre-list event backlog
                # (same relist semantics as resync); mid-list arrivals
                # overwrote their entry and survive for the next sweep
                for k, v in pre.items():
                    if self._dirty.get(k) is v:
                        del self._dirty[k]
                        self._dirty_at.pop(k, None)
            for o in objs:
                try:
                    self.sink.add_data(o)
                except Exception:
                    # transient write failure for a live object must
                    # NOT turn into a deletion below: keep it tracked
                    # at its old version so a later event/resync
                    # re-applies it
                    key = _obj_key(gvk, o)
                    if key in old_state:
                        state[key] = old_state[key]
                    continue
                state[_obj_key(gvk, o)] = _obj_ver(o)
                n += 1
        with self._lock:
            self._state = state
            # events raced during the rebuild stay dirty and re-apply
            # next sweep; rv no-op suppression keeps that cheap
            total = len(state)
        for key in old_state:
            if key not in state:
                self._remove_key(key)
                n += 1
        return {"dirty": n, "total": total}

    def stop(self) -> None:
        with self._lock:
            cancels = list(self._cancels.values())
            self._cancels.clear()
            self._poll.clear()
        for cancel in cancels:
            cancel()


class _PublishGate:
    """Mutual exclusion for status PUBLISH passes without a Lock held
    across kube-write retry backoffs.

    The three publish sites (streamed per-kind writes, flush writes,
    the post-sweep pass) must serialize against each other — the
    generation check-and-set they perform is only atomic under mutual
    exclusion — but each pass spends most of its time in
    `_write_kind_status`, whose kube PATCHes retry with backoff sleeps.
    The lockset tracer flagged exactly that: a `threading.Lock`
    held across `retry_call`'s `time.sleep`. Holding a *Lock object*
    there is a smell (an interrupt/timeout path blocking on the lock
    stalls behind another pass's network backoff with no way to see
    why), so the exclusion is a token instead: `__enter__` waits for
    the busy flag under an internal lock that is only ever held for
    the flag hand-off itself, then RELEASES it before the publish body
    runs. Same semantics at every `with` site, but no lock is held
    while a write sleeps — which is why the internal lock can be
    promoted to a gating locktrace site."""

    def __init__(self) -> None:
        # held only for busy-flag hand-offs — never across a write or
        # a sleep; gklint gates any held-across-blocking event on it
        self._lock = threading.Lock()  # locktrace: gate
        self._cv = threading.Condition(self._lock)
        self._busy = False

    def __enter__(self) -> "_PublishGate":
        with self._cv:
            while self._busy:
                self._cv.wait()
            self._busy = True
        return self

    def __exit__(self, *exc: Any) -> None:
        with self._cv:
            self._busy = False
            self._cv.notify()


class _KindStatusWriter:
    """Streaming constraint-status publisher for one interval sweep.

    The driver fires on_kind_results as each kind's sweep completes
    (delta-served, device-consumed, or interpreter); this writer drains
    those per-kind result batches on its own thread and issues the
    kind's delta'd status PATCHes IMMEDIATELY — so status API I/O
    overlaps the remaining kinds' device sweeps instead of forming one
    post-sweep assembly pass. Kinds it publishes are excluded from the
    post-sweep write pass; anything it failed on (API error, handler
    error) is left unstreamed so the post-sweep pass covers it."""

    # sentinel: live-pod set not resolved yet (computed on the writer
    # thread — a kube.list on the sweep thread before the tracker
    # drain would widen the event-drain race window)
    _UNRESOLVED = object()

    def __init__(self, manager: "AuditManager", force: bool, gen: int = 0):
        import queue

        self.manager = manager
        self.force = force
        # this sweep's evaluation generation: every status write this
        # writer issues is check-and-set against the manager's published
        # generation, so a slow streamed write can never clobber the
        # statuses of a NEWER flush/sweep that already published
        self.gen = gen
        self.live_pods: Any = self._UNRESOLVED
        self.q: Any = queue.Queue()
        self.written = 0
        self.skipped = 0
        self.pruned = 0
        self.wall_s = 0.0
        self.kinds: set = set()     # fully published kinds
        self._seen: set = set()     # kinds already streamed once
        self._thread: Optional[threading.Thread] = None
        self._finished = False

    def on_kind(self, target: str, kind: str, results: list) -> None:
        """Driver-thread callback: enqueue only (the sweep must never
        wait on status I/O). The writer thread spawns on first use so
        an armed-but-empty sweep costs nothing."""
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="audit-status-stream")
            self._thread.start()
        self.q.put((target, kind, list(results)))

    def _run(self) -> None:
        while True:
            item = self.q.get()
            if item is None:
                return
            if self.live_pods is self._UNRESOLVED:
                self.live_pods = (self.manager._live_pod_ids()
                                  if self.manager.gc_stale_statuses
                                  else None)
            target, kind, results = item
            t0 = time.monotonic()
            try:
                if kind in self._seen:
                    # a second target re-audited this kind: the first
                    # streamed write covered only its own target's
                    # results — un-stream the kind so the post-sweep
                    # pass re-writes it from the cross-target union
                    self.kinds.discard(kind)
                    continue
                self._seen.add(kind)
                handler = self.manager.opa.targets.get(target)
                if handler is not None:
                    memo: dict = {}
                    for r in results:
                        handler.handle_violation(r, memo)
                by_con = self.manager._group_by_constraint(results)
                with self.manager._status_lock:
                    if self.manager._published_gen > self.gen:
                        # a newer sweep/flush already published: its
                        # evaluation drained the inventory AFTER ours,
                        # so writing this kind now would roll statuses
                        # backwards — skip the write (this sweep's
                        # post-pass is gen-checked too, so the kind is
                        # simply owned by the newer publish)
                        continue
                    w, s, p = self.manager._write_kind_status(
                        kind, by_con, force=self.force,
                        live_pods=self.live_pods)
                    if w is None:
                        # list failed / breaker: post-sweep covers
                        continue
                    self.manager._published_gen = max(
                        self.manager._published_gen, self.gen)
                self.written += w
                self.skipped += s
                self.pruned += p
                self.kinds.add(kind)
            except Exception as e:
                # post-sweep pass repairs whatever this missed
                log.error("streamed status write failed; post-sweep "
                          "pass will cover the kind",
                          details={"kind": kind, "error": str(e)})
            finally:
                dt = time.monotonic() - t0
                self.wall_s += dt
                profiling.timers().add("status_write", dt)

    def finish(self) -> set:
        """Drain, stop, and return the fully-published kinds.
        Idempotent: the sweep's finally calls it again on the error
        path so a raising evaluation cannot leak the writer thread."""
        if self._finished or self._thread is None:
            self._finished = True
            return set(self.kinds) if self._thread is not None else set()
        self._finished = True
        self.q.put(None)
        self._thread.join(timeout=300)
        if self._thread.is_alive():
            # a wedged write must not also wedge the sweep epilogue —
            # fall back to the post-sweep pass for everything
            log.error("streamed status writer stalled; post-sweep pass "
                      "re-writes every kind")
            return set()
        return set(self.kinds)


class AuditManager:
    def __init__(self, kube, opa: Client,
                 interval: float = DEFAULT_AUDIT_INTERVAL,
                 constraint_violations_limit: int =
                 DEFAULT_CONSTRAINT_VIOLATIONS_LIMIT,
                 audit_from_cache: bool = False,
                 incremental: bool = False,
                 full_resync_every: int = DEFAULT_FULL_RESYNC_EVERY,
                 write_breaker=None, leader_check=None,
                 gc_stale_statuses: bool = True,
                 stream_audit: bool = False,
                 stream_window_s: float = DEFAULT_STREAM_WINDOW_S,
                 stream_max_batch: int = DEFAULT_STREAM_MAX_BATCH,
                 stream_status_writes: bool = True,
                 shard_plane: "Optional[ShardedAuditPlane]" = None):
        self.kube = kube
        self.opa = opa
        # sharded inventory plane: when set, sweeps evaluate on the N
        # audit shard processes (each owning a consistent-hash slice)
        # and the leader composes the per-kind results; the local
        # driver still serves admission/preview from the full inventory
        self.shard_plane = shard_plane
        self.interval = interval
        self.limit = constraint_violations_limit
        self.audit_from_cache = audit_from_cache
        self.incremental = incremental
        # HA: with leader election enabled, only the lease holder runs
        # sweeps — two replicas must not race each other's
        # constraint-status PATCHes. None = single-replica, always on
        self.leader_check = leader_check
        # prune byPod status entries whose pod no longer exists (a
        # replaced pod's statuses must be garbage-collected, not
        # accumulate across restarts)
        self.gc_stale_statuses = gc_stale_statuses
        # N <= 0 disables the PERIODIC re-encode (k8s resync-period
        # convention); the first sweep always encodes from scratch
        self.full_resync_every = full_resync_every
        # shared kube-write circuit breaker (resilience.CircuitBreaker):
        # while open, status writes are deferred for the sweep instead
        # of hot-looping retries against a down API server — the skip-
        # unchanged delta logic re-issues them once writes heal
        self.write_breaker = write_breaker
        self.tracker: Optional[InventoryTracker] = None
        self._sweeps = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_results: list = []
        self.last_sweep_stats: dict = {}
        # liveness heartbeat: stamped every loop iteration; healthy()
        # flags a dead/stalled audit loop for the k8s liveness probe
        self.heartbeat = time.monotonic()
        # streaming audit: evaluate dirty rows as watch events arrive
        # (debounce window + max-batch) instead of waiting out the
        # interval; the interval sweep stays as the reconciliation
        # backstop. Requires incremental mode — the whole point is the
        # persistent encoded inventory + results delta cache. Sharded
        # sweeps keep the interval cadence (the shard round-trip IS the
        # flush), so streaming is a leader-local-only mode.
        self.stream_audit = stream_audit and incremental \
            and shard_plane is None
        self.stream_window_s = max(0.0, stream_window_s)
        self.stream_max_batch = max(1, stream_max_batch)
        # streaming status publishing: interval sweeps write each
        # kind's constraint statuses AS ITS SWEEP COMPLETES (driver
        # on_kind_results hook) instead of one post-sweep pass, so
        # write I/O overlaps the remaining kinds' device sweeps
        self.stream_status_writes = stream_status_writes
        self._stream_thread: Optional[threading.Thread] = None
        self._stream_cv = threading.Condition()
        self._stream_signal = False
        # one EVALUATION at a time: the stream flush and the interval
        # backstop share the delta pipeline. Status publishing happens
        # OUTSIDE this lock (under _status_lock below) so a kube-write
        # retry backoff can never sleep while the evaluation pipeline —
        # and the follower drain, and streaming flushes — are blocked
        # behind it. gklint promotes held-across-blocking findings on
        # this allocation site from advisory to gating.
        self._sweep_lock = threading.Lock()  # locktrace: gate
        # one PUBLISH at a time, ordered by evaluation generation:
        # _eval_gen is assigned under _sweep_lock (strictly increasing
        # in evaluation order), _published_gen advances check-and-set
        # under _status_lock — a publish whose generation is older than
        # what's already published is skipped wholesale, so a slow
        # in-flight write pass cannot clobber newer statuses. The gate
        # is a token, not a Lock: kube-write retry backoffs sleep with
        # NO lock held (see _PublishGate), closing the locktrace
        # advisory on this site.
        self._status_lock = _PublishGate()
        self._eval_gen = 0
        self._published_gen = 0
        # rolling flush observability (bench + tests + /debug): counts
        # by outcome and the most recent detection-latency samples
        self.stream_stats = {"flushes": 0, "errors": 0, "skipped": 0,
                             "events": 0}
        # streaming status-write delta baseline: (kind, name) -> the
        # serialized violation entries last PUBLISHED. A flush lists +
        # compares only the kinds whose fingerprints moved, so per-event
        # write cost is O(changed constraints) in API list calls, not
        # O(all constraints) per flush. None = unknown (next flush does
        # one full live compare); never advanced on deferred writes.
        self._stream_fp: Optional[dict] = None
        # observer hook: called after each ok flush with
        # (detection_latencies_s, write_stats) — bench/tests attach here
        self.on_flush: Optional[Callable[[list, dict], None]] = None

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, name="audit",
                                        daemon=True)
        self._thread.start()
        if self.stream_audit:
            self._stream_thread = threading.Thread(
                target=self._stream_loop, name="audit-stream",
                daemon=True)
            self._stream_thread.start()

    def stop(self) -> None:
        self._stop.set()
        metrics.unregister_saturation_probe("audit-stream-pending")
        with self._stream_cv:
            self._stream_cv.notify_all()
        if self._stream_thread is not None:
            # wait the stream loop out BEFORE zeroing: an in-flight
            # flush's finally clause re-exports pending_count(), and
            # with the probe already unregistered a zero written under
            # it would be overwritten into a phantom backlog forever
            self._stream_thread.join(timeout=10.0)
        if self.stream_audit and self.tracker is not None:
            # the gauge is SET-only: a stopped stream must not export
            # its last backlog forever
            metrics.report_stream_pending(0)
        if self.tracker is not None:
            self.tracker.stop()
        if self.shard_plane is not None:
            self.shard_plane.stop()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.heartbeat = time.monotonic()
            if self.leader_check is not None and not self.leader_check():
                # follower replica: keep the heartbeat fresh (the pod is
                # healthy, just not leading) and poll for promotion at a
                # sub-lease cadence so failover costs one lease duration.
                # The tracker still DRAINS: a warm-restored follower must
                # re-validate (readyz's state-restore gate), its dirty
                # map must not grow unboundedly while following, and a
                # promoted survivor should sweep over a current
                # inventory, not a stale one.
                if self.shard_plane is not None:
                    # follower keeps the shard slices current too: a
                    # promoted survivor's first sweep must find every
                    # shard's encoded rows fresh, not an interval stale
                    try:
                        with self._sweep_lock:
                            self.shard_plane.apply_pending()
                    except Exception as e:
                        log.error("follower shard-inventory sync failed",
                                  details=str(e))
                elif self.incremental and self.tracker is not None \
                        and not self.stream_audit:
                    # with streaming on, the stream loop owns follower
                    # drains (skipped flushes) — double-draining here
                    # would race it for the same dirty entries
                    try:
                        with self._sweep_lock:
                            self.tracker.apply_pending()
                    except Exception as e:
                        log.error("follower inventory sync failed",
                                  details=str(e))
                self._stop.wait(min(self.interval, 1.0))
                continue
            try:
                self.audit_once()
            except Exception as e:
                log.error("audit failed", details=str(e))
            self.heartbeat = time.monotonic()
            self._stop.wait(self.interval)

    def healthy(self, max_stall: Optional[float] = None) -> bool:
        """Liveness: the loop thread is alive and has heartbeaten within
        max_stall (default: generous multiple of the sweep interval).
        Sweeps stamp PROGRESS heartbeats (per listed GVK, per status
        write), so a long sweep that keeps moving never trips the
        watchdog; only one that stalls for max_stall inside a single
        step does."""
        if self._thread is None:
            return True  # not started yet
        if not self._thread.is_alive():
            return self._stop.is_set()  # stopped on purpose is fine
        if max_stall is None:
            max_stall = max(10 * self.interval, 300.0)
        return time.monotonic() - self.heartbeat <= max_stall

    # ----------------------------------------------------- streaming audit

    def _stream_loop(self) -> None:
        """Event-driven violation detection: wake on the tracker's
        watch-event notification, debounce for stream_window_s (a burst
        coalesces into one flush; stream_max_batch pending events flush
        early), evaluate ONLY the dirty rows through the delta pipeline,
        and publish changed constraint statuses — event-to-status in
        milliseconds instead of up to a full --audit-interval."""
        # the tracker is built lazily by the first interval sweep (or a
        # warm restore); arm its event hooks as soon as it exists
        while not self._stop.is_set():
            tracker = self.tracker
            if tracker is not None:
                break
            self._stop.wait(0.05)
        if self._stop.is_set():
            return

        def on_event():
            with self._stream_cv:
                self._stream_signal = True
                self._stream_cv.notify()

        tracker.track_event_times = True
        tracker.on_event = on_event
        # the streaming backlog was only visible in logs: export the
        # dirty-key depth as a gauge, refreshed around every flush AND
        # on each scrape, so backlog growth (detection latency about to
        # follow) is scrapeable before it becomes a latency incident
        metrics.register_saturation_probe(
            "audit-stream-pending",
            lambda: metrics.report_stream_pending(
                tracker.pending_count()))
        log.info("streaming audit armed",
                 details={"window_ms": round(self.stream_window_s * 1e3),
                          "max_batch": self.stream_max_batch})
        while not self._stop.is_set():
            with self._stream_cv:
                while not self._stream_signal and not self._stop.is_set():
                    # periodic wake: events buffered while the flush ran
                    # (their notify landed before the wait) must not sit
                    # until the next fresh event
                    self._stream_cv.wait(0.25)
                    if self.tracker is not None and \
                            self.tracker.pending_count():
                        break
                self._stream_signal = False
            if self._stop.is_set():
                return
            # debounce: let the burst land, but flush early on a full
            # batch and never hold an event past ~2 windows — if the
            # oldest buffered event already aged (the wake-up lagged the
            # event, e.g. a flush was in flight when it landed), the
            # wait shrinks so oldest-age + wait <= 2 windows
            age = tracker.oldest_pending_age() or 0.0
            deadline = time.monotonic() + max(
                0.0, min(self.stream_window_s,
                         2 * self.stream_window_s - age))
            while time.monotonic() < deadline and not self._stop.is_set():
                if self.tracker.pending_count() >= self.stream_max_batch:
                    break
                self._stop.wait(min(0.005, self.stream_window_s or 0.005))
            if self._stop.is_set():
                return
            try:
                self._stream_flush()
            except Exception as e:
                # the interval backstop repairs whatever this flush
                # missed; the error must still be visible
                self.stream_stats["errors"] += 1
                metrics.report_stream_flush("error")
                log.error("stream flush failed; interval backstop will "
                          "reconcile", details=str(e))
            finally:
                # per-flush gauge refresh: pending drops to ~0 after a
                # healthy flush; a stuck writer leaves it growing
                metrics.report_stream_pending(tracker.pending_count())

    def _stream_flush(self) -> None:
        tracker = self.tracker
        if tracker is None or tracker.pending_count() == 0:
            return
        if self.leader_check is not None and not self.leader_check():
            # follower: keep the inventory current (a promoted survivor
            # must sweep over fresh rows) but never write statuses
            with self._sweep_lock:
                tracker.apply_pending()
            self.stream_stats["skipped"] += 1
            metrics.report_stream_flush("skipped")
            return
        # EVALUATION under _sweep_lock only: the status publish below
        # happens after the lock drops (under _status_lock), so the
        # kube-retry backoff of a flaky status write can never sleep
        # while the evaluation pipeline is blocked behind this flush
        with self._sweep_lock:
            if self._sweeps == 0:
                # cold bootstrap pending: the first interval sweep's
                # full re-encode will cover these events
                return
            t0 = time.monotonic()
            stats = tracker.apply_pending()
            event_ts = stats.pop("event_ts", None) or []
            if stats["dirty"] == 0 and not event_ts:
                return  # pure no-op events (rv echoes)
            self._eval_gen += 1
            gen = self._eval_gen
            drv = getattr(self.opa, "driver", None)
            cap_armed = hasattr(drv, "audit_violations_cap")
            if cap_armed:
                drv.audit_violations_cap = self.limit
            tr = gtrace.TRACER.start(gtrace.AUDIT)
            try:
                with tr.span("evaluate"):
                    try:
                        results = self.opa.audit().results()
                    finally:
                        if cap_armed:
                            drv.audit_violations_cap = None
            except BaseException as e:
                tr.set_status("error")
                tr.set_attr("error", str(e))
                tr.finish()
                raise
        superseded = False
        try:
            by_constraint = self._group_by_constraint(results)
            cur_fp = {k: self._status_entries(v)
                      for k, v in by_constraint.items()}
            with self._status_lock:
                if self._published_gen > gen:
                    # a newer sweep already published: skipping this
                    # flush wholesale is safe (its evaluation drained
                    # the tracker after ours) — writing would clobber
                    # the newer statuses with older ones
                    superseded = True
                    writes = {"status_writes": 0, "status_skipped": 0,
                              "status_deferred": False,
                              "status_superseded": True}
                else:
                    # delta against the last published fingerprints:
                    # only kinds whose violation sets moved get
                    # listed/compared this flush (unknown baseline =
                    # one full live pass)
                    prev_fp = self._stream_fp
                    kinds = None
                    if prev_fp is not None:
                        kinds = {key[0]
                                 for key in set(prev_fp) | set(cur_fp)
                                 if prev_fp.get(key) != cur_fp.get(key)}
                    with tr.span("status_writes"):
                        if kinds is not None and not kinds:
                            # nothing moved: the no-op verdict needs no
                            # API traffic at all
                            writes = {"status_writes": 0,
                                      "status_skipped": len(cur_fp),
                                      "status_deferred": False}
                        else:
                            writes = self._write_audit_results(
                                by_constraint, kinds=kinds)
                    if not writes.get("status_deferred"):
                        self._stream_fp = cur_fp
                        self._published_gen = max(self._published_gen,
                                                  gen)
            tr.set_status("stream")
            tr.set_attr("dirty", stats["dirty"])
        except BaseException as e:
            tr.set_status("error")
            tr.set_attr("error", str(e))
            raise
        finally:
            tr.finish()
        self.stream_stats["flushes"] += 1
        self.stream_stats["events"] += len(event_ts)
        if not superseded:
            self.last_results = results
        metrics.report_audit_sweep("stream")
        if superseded:
            # the overtaking publish covered these events' state; their
            # detection latency is attributed there, not double-counted
            self.stream_stats["skipped"] += 1
            metrics.report_stream_flush("skipped")
            lat = []
        elif writes.get("status_deferred"):
            # breaker open: statuses did NOT publish — the flush is
            # an error and these events record NO detection latency
            # (a sub-second sample here would claim a detection that
            # never reached status; the pending deltas re-issue on
            # the first healthy sweep, counted as backstop drift).
            # The fingerprint baseline does not advance either, so
            # the next flush re-lists and re-issues these kinds.
            self.stream_stats["errors"] += 1
            metrics.report_stream_flush("error")
            lat = []
        else:
            # the detection clock stops when the status writes that
            # publish the verdicts have completed (or were
            # confirmed no-ops — an unchanged violation set IS the
            # verdict)
            now = time.monotonic()
            lat = [max(0.0, now - ts) for ts in event_ts]
            for s in lat:
                metrics.report_violation_detection(s)
            metrics.report_stream_flush("ok")
        dt = time.monotonic() - t0
        if lat:
            log.info("stream flush",
                     details={"dirty": stats["dirty"],
                              "events": len(lat),
                              "violations": len(results),
                              "detect_p_max_ms":
                                  round(max(lat) * 1e3, 1),
                              "flush_s": round(dt, 4), **writes})
        cb = self.on_flush
        if cb is not None:
            try:
                cb(lat, writes)
            except Exception:
                pass  # observer only; never fail the flush

    # --------------------------------------------------------- warm restart

    def restore_state(self, snap: dict) -> int:
        """Seed the incremental tracker from a state snapshot (see
        statestore.py; the driver's data tree is restored separately,
        before this). The first sweep then runs INCREMENTAL — a live-
        list (uid, rv) re-validation plus whatever delta accumulated
        while down — instead of the forced from-scratch re-encode a
        cold boot pays."""
        if self.shard_plane is not None:
            n = self.shard_plane.restore_state(snap)
            if n:
                # sweep 0 forces a full re-encode (cold bootstrap); a
                # restored plane starts at sweep 1 so the backstop
                # cadence is kept but the boot sweep stays incremental
                self._sweeps = 1
            return n
        if not self.incremental:
            return 0
        self.tracker = InventoryTracker(self.kube, self.opa)
        n = self.tracker.restore(snap)
        # sweep 0 forces a full re-encode (cold bootstrap); a restored
        # tracker starts at sweep 1 so the backstop cadence is kept but
        # the boot sweep stays incremental
        self._sweeps = 1
        return n

    def restore_ready(self) -> bool:
        """readyz gate: restored state must be re-validated against a
        live list before the pod reports Ready (trivially true when
        nothing was restored)."""
        if self.shard_plane is not None:
            return self.shard_plane.restore_ready()
        return self.tracker is None or self.tracker.validated.is_set()

    def snapshot_state(self) -> Optional[dict]:
        """Tracker section of the state snapshot; None before the first
        incremental sweep built a tracker."""
        if self.shard_plane is not None:
            return self.shard_plane.snapshot_state()
        if self.tracker is None:
            return None
        return self.tracker.snapshot()

    # ----------------------------------------------------------------- audit

    def audit_once(self) -> list:
        t0 = time.monotonic()
        self.heartbeat = time.monotonic()
        # every sweep is traced (a handful of span objects per minute):
        # the audit plane's flight-recorder entries and per-phase
        # histograms exist regardless of the admission sample rate.
        # The driver's internals accumulate into the process-global
        # PhaseTimers; the snapshot diff below turns this sweep's
        # encode / device_sweep / materialize / interp_eval /
        # delta_serve time into trace phases.
        tr = gtrace.TRACER.start(gtrace.AUDIT, force=True)
        try:
            # evaluation is serialized with the streaming flush (both
            # drive the same delta pipeline); publishing happens AFTER
            # the lock drops, under _status_lock, so status-write retry
            # backoff never sleeps while evaluation is blocked
            with self._sweep_lock:
                pub = self._audit_once_traced(tr, t0)
            return self._publish_sweep(tr, t0, pub)
        except BaseException as e:
            # a failing sweep must still land in the flight recorder —
            # the sweeps that error (API outage, eval blowup) are
            # exactly the ones worth diagnosing after the fact
            tr.set_status("error")
            tr.set_attr("error", str(e))
            raise
        finally:
            tr.finish()

    def _audit_once_traced(self, tr, t0: float) -> dict:
        """Evaluation half of one interval sweep, under _sweep_lock.
        Returns the publish payload _publish_sweep consumes once the
        lock has dropped."""
        timers = profiling.timers()
        phases0 = timers.snapshot()
        sweep_stats: dict = {}
        # evaluation generation: assigned under _sweep_lock, strictly
        # increasing in evaluation order — the publish step's clobber
        # guard (and the streamed writer's) key off it
        self._eval_gen += 1
        gen = self._eval_gen
        # streaming status publishing: arm the driver's per-kind
        # completion hook so each kind's constraint statuses PATCH
        # while later kinds are still sweeping on the device. The
        # force decision must be made BEFORE the sweep (it matches the
        # full-resync cadence _audit_incremental computes from the
        # same counter).
        driver = getattr(self.opa, "driver", None)
        writer: Optional[_KindStatusWriter] = None
        delta_mode = self.incremental or self.shard_plane is not None
        would_force = (not delta_mode or self._sweeps == 0
                       or (self.full_resync_every > 0
                           and self._sweeps % self.full_resync_every
                           == 0))
        if (self.stream_status_writes
                and (delta_mode or self.audit_from_cache)
                and (self.shard_plane is not None
                     or hasattr(driver, "on_kind_results"))
                and (self.leader_check is None or self.leader_check())
                and not (self.write_breaker is not None
                         and self.write_breaker.is_open)):
            writer = _KindStatusWriter(self, would_force, gen=gen)
            if self.shard_plane is None:
                driver.on_kind_results = writer.on_kind
        # per-constraint violations cap, armed for THIS sweep only:
        # direct client.audit() callers and previews that share the
        # driver stay uncapped (materialize counts every pair either
        # way; past the cap only the message assembly is skipped)
        cap_armed = hasattr(driver, "audit_violations_cap")
        if cap_armed:
            driver.audit_violations_cap = self.limit
        t_ev0 = time.monotonic()
        try:
            return self._audit_evaluate(tr, t_ev0, timers, phases0,
                                        sweep_stats, writer, gen)
        finally:
            if cap_armed:
                driver.audit_violations_cap = None
            if writer is not None:
                if self.shard_plane is None:
                    driver.on_kind_results = None
                # error-path backstop: a raising evaluation must not
                # leak the writer thread (finish is idempotent)
                writer.finish()

    def _audit_evaluate(self, tr, t_ev0, timers, phases0,
                        sweep_stats, writer, gen) -> dict:
        if self.shard_plane is not None:
            results, sweep_stats = self._audit_sharded(tr, writer)
            ev_wall = sweep_stats.pop("_eval_wall_s", 0.0)
        elif self.incremental:
            results, sweep_stats = self._audit_incremental(tr)
            ev_wall = sweep_stats.pop("_eval_wall_s", 0.0)
        elif self.audit_from_cache:
            # one vectorized sweep over the synced inventory
            results = self.opa.audit().results()
            ev_wall = time.monotonic() - t_ev0
            metrics.report_audit_sweep("full")
        else:
            results = self._audit_resources()
            ev_wall = time.monotonic() - t_ev0
            metrics.report_audit_sweep("full")
        # streamed per-kind status writes ride the sweep itself: wait
        # them out first so their wall time and published-kind set are
        # final before the post-sweep pass
        streamed_kinds: set = set()
        stream_write_s = 0.0
        if writer is not None:
            streamed_kinds = writer.finish()
            stream_write_s = writer.wall_s
        # phase attribution, double-count-free: when the driver
        # instrumented its internals (encode / device_sweep /
        # materialize / interp_eval / delta_serve — all inside the
        # evaluation wall), the trace records THOSE plus the
        # uncovered remainder as evaluate_other, so stages sum to the
        # sweep. An uninstrumented driver records one aggregate
        # evaluate span instead. status_write accrues on the streaming
        # writer's OWN thread (overlapping the sweep) — it is reported
        # as its own phase, never subtracted from the eval wall.
        phases = profiling.PhaseTimers.diff(phases0, timers.snapshot())
        phases.pop("status_write", None)
        if phases:
            for name, secs in sorted(phases.items()):
                # gklint: allow(stage) reason=names originate from PhaseTimers call sites, each a checked literal
                tr.add_phase(name, secs)
            residual = ev_wall - sum(phases.values())
            if residual > 1e-6:
                tr.add_phase("evaluate_other", residual)
        elif ev_wall > 0:
            tr.add_phase("evaluate", ev_wall)
        if stream_write_s > 0:
            tr.add_phase("status_write_stream", stream_write_s)
        return {"gen": gen, "results": results,
                "sweep_stats": sweep_stats, "writer": writer,
                "streamed_kinds": streamed_kinds,
                "stream_write_s": stream_write_s}

    def _publish_sweep(self, tr, t0, pub) -> list:
        """Publishing half of one interval sweep: constraint-status
        writes under _status_lock, generation check-and-set so a stale
        publish (a newer flush/sweep already wrote) is skipped wholesale
        instead of rolling statuses backwards. Safe to skip entirely:
        generation order implies inventory-recency order — the newer
        evaluation drained the tracker AFTER this one, so its published
        statuses already cover everything this one saw."""
        gen = pub["gen"]
        results = pub["results"]
        sweep_stats = pub["sweep_stats"]
        writer = pub["writer"]
        streamed_kinds = pub["streamed_kinds"]
        stream_write_s = pub["stream_write_s"]
        by_constraint = self._group_by_constraint(results)
        # delta'd status writes are a delta-pipeline behavior: the
        # discovery and from-cache modes keep upstream semantics (every
        # sweep rewrites every status, refreshing auditTimestamp). In
        # incremental/sharded mode, full-resync sweeps force every
        # write so the timestamp still refreshes on that cadence
        force_writes = (not (self.incremental
                             or self.shard_plane is not None)
                        or sweep_stats.get("sweep") == "full_resync")
        # reuse the streamed writer's resolved live-pod set: the
        # post-sweep pass must not pay a second cluster-wide pod list
        lp = self._LIVE_PODS_UNSET
        if writer is not None and \
                writer.live_pods is not _KindStatusWriter._UNRESOLVED:
            lp = writer.live_pods
        t_w0 = time.monotonic()
        superseded = False
        with self._status_lock:
            if self._published_gen > gen:
                superseded = True
                writes = {"status_writes": 0, "status_skipped": 0,
                          "status_deferred": False,
                          "status_superseded": True}
            else:
                with tr.span("status_writes"):
                    writes = self._write_audit_results(
                        by_constraint, force=force_writes,
                        exclude_kinds=streamed_kinds or None,
                        live_pods=lp)
                if not writes.get("status_deferred"):
                    self._published_gen = max(self._published_gen, gen)
                # a full interval sweep (re)establishes the streaming
                # delta baseline — unless the breaker deferred the
                # writes, in which case what is published is unknown
                if self.stream_audit:
                    self._stream_fp = \
                        None if writes.get("status_deferred") \
                        else {k: self._status_entries(v)
                              for k, v in by_constraint.items()}
        if writer is not None:
            writes["status_writes"] = (writes.get("status_writes", 0)
                                       + writer.written)
            writes["status_skipped"] = (writes.get("status_skipped", 0)
                                        + writer.skipped)
            if writer.pruned:
                writes["status_gc"] = (writes.get("status_gc", 0)
                                       + writer.pruned)
            if streamed_kinds:
                writes["status_streamed_kinds"] = len(streamed_kinds)
        sweep_stats["status_write_s"] = round(
            stream_write_s + (time.monotonic() - t_w0), 4)
        streaming = (self.stream_audit and self._stream_thread is not None
                     and sweep_stats.get("sweep") == "incremental")
        if streaming:
            # backstop role: with the streaming path keeping statuses
            # current, any non-forced write this interval sweep had to
            # issue is drift the event pipeline missed (or an external
            # clobber it repaired) — 0 in steady state
            drift = writes.get("status_writes", 0)
            metrics.report_backstop_drift(drift)
            if drift:
                writes["backstop_drift"] = drift
                log.warning("interval backstop repaired constraint-"
                            "status drift", details={"writes": drift})
        event_ts = sweep_stats.pop("_event_ts", None) or []
        if event_ts and self.stream_audit:
            # events the BACKSTOP drained (the stream loop missed or
            # raced them): their detection latency is real — it lands
            # in the same histogram as the streaming path's, honestly
            # fattening the tail it is supposed to beat
            now = time.monotonic()
            for ts in event_ts:
                metrics.report_violation_detection(max(0.0, now - ts))
        dt = time.monotonic() - t0
        metrics.report_audit_duration(dt)
        metrics.report_audit_last_run()
        by_action: dict[str, int] = {}
        for r in results:
            by_action[r.enforcement_action] = \
                by_action.get(r.enforcement_action, 0) + 1
        for action, count in by_action.items():
            metrics.report_violations(action, count)
        if not superseded:
            # a superseded publish must not roll the observable sweep
            # state back behind the newer publish that overtook it
            self.last_results = results
            self.last_sweep_stats = sweep_stats
        details = {"violations": len(results), "duration_s": round(dt, 3),
                   **sweep_stats, **writes}
        driver = getattr(self.opa, "driver", None)
        if hasattr(driver, "quarantine_status"):
            q = driver.quarantine_status()
            if q:
                details["quarantined"] = q
        if hasattr(driver, "warm_status"):
            st = driver.warm_status()
            metrics.report_device_programs(st["warm"], st["compiling"])
            details["device_programs"] = st
            path = getattr(
                driver,
                "last_audit_path"
                if (self.audit_from_cache or self.incremental)
                else "last_review_batch_path", None)
            if path:
                details["audit_path"] = path
        tr.set_status(sweep_stats.get("sweep") or "full")
        tr.set_attr("violations", len(results))
        for k in ("dirty", "inventory"):
            if k in sweep_stats:
                tr.set_attr(k, sweep_stats[k])
        if "audit_path" in details:
            tr.set_attr("audit_path", details["audit_path"])
        # finish() runs in audit_once's finally, error or not
        log.info("audit complete", details=details)
        return results

    def _audit_sharded(self, tr, writer) -> tuple[list, dict]:
        """Sharded sweep: drain every shard slice's tracker (deltas
        route to the owning engine process, plus the join-broadcast
        columns everywhere), dispatch one capped sweep per shard over
        the backplane, and compose the per-kind results into ONE audit
        round — bit-equal to the unsharded sweep (see
        compose_shard_results). Kinds feed the streamed status writer
        as they compose, so write I/O overlaps the remaining merge."""
        plane = self.shard_plane
        full = self._sweeps == 0 or (
            self.full_resync_every > 0
            and self._sweeps % self.full_resync_every == 0)
        self._sweeps += 1
        t0 = time.monotonic()
        with tr.span("list_delta_apply"):
            if full:
                stats = plane.full_resync(_auditable_gvks(self.kube))
                metrics.report_audit_sweep("full_resync")
            else:
                stats = plane.apply_pending()
                metrics.report_audit_sweep("incremental")
        sync_s = time.monotonic() - t0
        t_ev0 = time.monotonic()
        with tr.span("shard_sweeps"):
            results, shard_stats = plane.sweep(
                self.limit, writer=writer,
                heartbeat=lambda: setattr(self, "heartbeat",
                                          time.monotonic()))
        ev_wall = time.monotonic() - t_ev0
        metrics.report_audit_dirty(stats["dirty"], stats["total"], 0)
        return results, {
            "sweep": "full_resync" if full else "incremental",
            "dirty": stats["dirty"], "inventory": stats["total"],
            "sync_s": round(sync_s, 3), "shards": plane.shard_count,
            **shard_stats,
            "_eval_wall_s": ev_wall,
            "_event_ts": stats.get("event_ts") or [],
        }

    def _audit_incremental(self, tr=gtrace.NOOP) -> tuple[list, dict]:
        """Delta sweep: apply the tracker's pending adds/updates/deletes
        to the persistent encoded inventory (the driver patches only the
        dirty rows), then run the vectorized cached audit. Every
        full_resync_every-th sweep re-encodes everything from scratch."""
        driver = getattr(self.opa, "driver", None)
        strtab = getattr(driver, "strtab", None)
        snap = strtab.snapshot() if strtab is not None else None
        if self.tracker is None:
            self.tracker = InventoryTracker(self.kube, self.opa)
        full = self._sweeps == 0 or (
            self.full_resync_every > 0
            and self._sweeps % self.full_resync_every == 0)
        self._sweeps += 1
        t0 = time.monotonic()
        with tr.span("list_delta_apply"):
            if full:
                # drop BEFORE re-adding: with warm caches every re-add
                # would run the per-object patch machinery whose work
                # the drop then discards; cold caches make each write
                # an early return
                if hasattr(driver, "drop_inventory_caches"):
                    driver.drop_inventory_caches()
                stats = self.tracker.full_resync(
                    _auditable_gvks(self.kube))
                metrics.report_audit_sweep("full_resync")
            else:
                stats = self.tracker.apply_pending()
                metrics.report_audit_sweep("incremental")
        sync_s = time.monotonic() - t0
        t_ev0 = time.monotonic()
        results = self.opa.audit().results()
        ev_wall = time.monotonic() - t_ev0
        grown = strtab.grown_since(snap) if strtab is not None else 0
        metrics.report_audit_dirty(stats["dirty"], stats["total"], grown)
        return results, {
            "sweep": "full_resync" if full else "incremental",
            "dirty": stats["dirty"], "inventory": stats["total"],
            "sync_s": round(sync_s, 3), "vocab_grown": grown,
            # evaluation wall clock for the caller's phase attribution
            # (popped before the stats reach the log line), and the
            # receipt times of any events this sweep drained (streaming
            # mode: the backstop's detections are histogrammed too)
            "_eval_wall_s": ev_wall,
            "_event_ts": stats.get("event_ts") or [],
        }

    def _audit_resources(self) -> list:
        """Discovery-driven sweep: list every listable GVK and feed the
        objects through the driver's BATCHED inventory evaluation (the
        reference reviews one object at a time here)."""
        from ..target.handler import AugmentedUnstructured

        # stage all live objects into a scratch audit client: reuse the
        # driver's vectorized audit over inventory (external data paths)
        results = []
        staged: list[dict] = []
        # listed Namespaces, sideloaded onto each namespaced review so
        # namespaceSelector constraints resolve from the live cluster
        # state — NOT just synced inventory (reference wraps every object
        # as AugmentedUnstructured{obj, ns}, manager.go:250-271);
        # _auditable_gvks (shared with the incremental tracker) lists
        # Namespaces first so the map is complete before any namespaced
        # object is staged
        ns_by_name: dict[str, dict] = {}
        saw_ns_kind = False
        for gvk in _auditable_gvks(self.kube):
            # progress heartbeat: a legitimately long discovery sweep
            # keeps beating per GVK, so the liveness watchdog only
            # trips on a sweep that stopped making progress
            self.heartbeat = time.monotonic()
            try:
                objs = self.kube.list(gvk)
            except KubeError:
                continue
            if gvk == ("", "v1", "Namespace"):
                saw_ns_kind = True
                for o in objs:
                    name = (o.get("metadata") or {}).get("name")
                    if name:
                        ns_by_name[name] = o
            staged.extend(objs)
        if not saw_ns_kind:
            # discovery may exclude Namespaces (RBAC-filtered lists);
            # fetch them explicitly — without this map every
            # namespaceSelector constraint autorejects. A FAILED listing
            # aborts the sweep: with no map, augmented() would skip every
            # namespaced object and the status write would then wipe all
            # previously-reported violations cluster-wide
            for o in self.kube.list(("", "v1", "Namespace")):
                name = (o.get("metadata") or {}).get("name")
                if name:
                    ns_by_name[name] = o

        ns_missing: set[str] = set()

        def resolve_ns(name: str) -> Optional[dict]:
            """Map hit, else a direct GET (a namespace created after the
            one-time snapshot — the reference's per-object nsCache.Get
            does the same on a cache miss). Failures are negative-cached
            for the sweep: N orphaned objects in a deleted namespace
            must cost one GET, not N."""
            ns_obj = ns_by_name.get(name)
            if ns_obj is None:
                if name in ns_missing:
                    return None
                try:
                    ns_obj = self.kube.get(("", "v1", "Namespace"), name)
                except KubeError:
                    ns_missing.add(name)
                    log.error("unable to look up object namespace; "
                              "skipping its objects this sweep",
                              details={"namespace": name})
                    return None
                ns_by_name[name] = ns_obj
            return ns_obj

        def augmented(o: dict) -> Optional[AugmentedUnstructured]:
            """Reference semantics (manager.go:250-271 + target.go:129-135):
            EVERY object gets a namespace sideload — the listed Namespace
            for namespaced objects (suppressing autoreject and giving the
            selector real labels), an EMPTY namespace for cluster-scoped
            ones (the reference's `&corev1.Namespace{}`, so selectors see
            no labels rather than autorejecting). An object whose
            namespace cannot be resolved is skipped, as the reference
            skips on a failed namespace fetch."""
            ns = (o.get("metadata") or {}).get("namespace")
            if not ns:
                return AugmentedUnstructured(o, {"metadata": {}})
            ns_obj = resolve_ns(ns)
            if ns_obj is None:
                return None
            return AugmentedUnstructured(o, ns_obj)

        # evaluate via the driver's batch review API when available,
        # falling back to per-object review
        driver = self.opa.driver
        target = "admission.k8s.gatekeeper.sh"
        if hasattr(driver, "review_batch"):
            handler = self.opa.targets[target]
            reviews = []
            for o in staged:
                aug = augmented(o)
                if aug is None:
                    continue
                handled, review = handler.handle_review(aug)
                if handled:
                    reviews.append(review)
            batches = driver.review_batch(target, reviews)
            for per_review in batches:
                for r in per_review:
                    handler.handle_violation(r)
                    results.append(r)
        else:
            for o in staged:
                aug = augmented(o)
                if aug is None:
                    continue
                results.extend(self.opa.review(aug).results())
        return results

    # ------------------------------------------------------------ aggregation

    def _group_by_constraint(self, results) -> dict[tuple, list]:
        grouped: dict[tuple, list] = {}
        for r in results:
            c = r.constraint or {}
            key = (c.get("kind") or "", (c.get("metadata") or {}).get("name")
                   or "")
            grouped.setdefault(key, []).append(r)
        return grouped

    def _write_kind_status(self, kind: str, by_constraint: dict,
                           force: bool, live_pods) -> tuple:
        """List + delta-compare + write ONE kind's constraint statuses.
        Returns (written, skipped, pruned), or (None, 0, 0) when the
        kind could not be covered (list failure / breaker open) so the
        caller leaves it for a later pass."""
        if self.write_breaker is not None and self.write_breaker.is_open:
            return (None, 0, 0)
        gvk = (CONSTRAINT_GROUP, "v1beta1", kind)
        try:
            constraints = self.kube.list(gvk)
        except KubeError:
            return (None, 0, 0)
        written = skipped = pruned = 0
        for obj in constraints:
            self.heartbeat = time.monotonic()  # progress per write
            name = (obj.get("metadata") or {}).get("name") or ""
            violations = by_constraint.get((kind, name), [])
            entries = self._status_entries(violations)
            gced = live_pods is not None and \
                prune_stale_by_pod(obj, live_pods)
            pruned += 1 if gced else 0
            cur = obj.get("status") or {}
            if not force and not gced and \
                    cur.get("totalViolations") == len(violations) \
                    and (cur.get("violations") or []) == entries:
                skipped += 1
                continue
            if self._update_constraint_status(obj, entries,
                                              len(violations)):
                written += 1
        return (written, skipped, pruned)

    _LIVE_PODS_UNSET = object()

    def _write_audit_results(self, by_constraint: dict[tuple, list],
                             force: bool = False,
                             kinds: Optional[set] = None,
                             exclude_kinds: Optional[set] = None,
                             live_pods=_LIVE_PODS_UNSET) -> dict:
        """status.byPod[audit] style update with cap + truncation + retry
        (manager.go:428-574). Constraints with no violations this run get
        their violation list cleared — but a constraint whose CURRENT
        status (fresh from the list) already carries exactly the
        violation set this sweep would publish is skipped, so a
        steady-state sweep issues O(changed constraints) PATCHes, not
        O(constraints). Comparing against the live status (not a local
        fingerprint) means an externally clobbered status self-heals on
        the next sweep. `force` writes everything (full-resync sweeps
        use it to refresh auditTimestamp periodically)."""
        if self.write_breaker is not None and self.write_breaker.is_open:
            # API-server writes are circuit-broken: defer ALL status
            # writes this sweep (no hot-loop of doomed PATCHes). The
            # violation deltas stay pending — the skip-unchanged
            # comparison below re-issues them on the first healthy sweep
            log.warning("kube-write breaker open; deferring constraint "
                        "status writes this sweep")
            return {"status_writes": 0, "status_skipped": 0,
                    "status_deferred": True}
        target_kinds = set()
        for kind in self.opa.template_kinds():
            target_kinds.add(kind)
        if kinds is not None:
            # streaming flushes restrict the list+compare to the kinds
            # whose violation fingerprints moved (the backstop sweep
            # passes None and still covers everything, so external
            # clobbers of untouched kinds heal there, as drift)
            target_kinds &= kinds
        if exclude_kinds:
            # already published mid-sweep by the streaming status
            # writer: re-listing them here would double the API load
            target_kinds -= exclude_kinds
        if live_pods is self._LIVE_PODS_UNSET:
            live_pods = (self._live_pod_ids()
                         if self.gc_stale_statuses else None)
        written = skipped = pruned = 0
        for kind in sorted(target_kinds):
            w, s, p = self._write_kind_status(kind, by_constraint,
                                              force=force,
                                              live_pods=live_pods)
            if w is None:
                continue
            written += w
            skipped += s
            pruned += p
        pruned += self._gc_template_statuses(live_pods)
        metrics.report_audit_status_writes(written, skipped)
        out = {"status_writes": written, "status_skipped": skipped}
        if pruned:
            out["status_gc"] = pruned
        return out

    def _live_pod_ids(self) -> Optional[set]:
        """Pod names of the live gatekeeper replicas in our namespace,
        for byPod status GC. None (= skip GC) when the listing fails or
        shows no labeled pods at all — partial visibility must never
        garbage-collect a living replica's status."""
        from .util import pod_name, pod_namespace

        try:
            pods = self.kube.list(("", "v1", "Pod"), pod_namespace())
        except KubeError:
            return None
        live = set()
        for p in pods:
            meta = p.get("metadata") or {}
            if "gatekeeper.sh/system" in (meta.get("labels") or {}):
                live.add(meta.get("name"))
        if not live:
            return None  # can't see replica pods (RBAC/dev): don't GC
        live.add(pod_name())
        return live

    def _gc_template_statuses(self, live_pods: Optional[set]) -> int:
        """Prune replaced pods' byPod entries from ConstraintTemplate
        statuses (the leader sweeps these once per audit)."""
        if live_pods is None:
            return 0
        template_gvk = ("templates.gatekeeper.sh", "v1beta1",
                        "ConstraintTemplate")
        pruned = 0
        try:
            templates = self.kube.list(template_gvk)
        except KubeError:
            return 0
        from .resilience import guarded_status_update

        for obj in templates:
            if not prune_stale_by_pod(obj, live_pods):
                continue

            def refresh(cur_obj, _gvk=template_gvk):
                try:
                    cur = self.kube.get(
                        _gvk, (cur_obj.get("metadata") or {})
                        .get("name") or "")
                except KubeError:
                    return None
                if not prune_stale_by_pod(cur, live_pods):
                    return None
                return cur

            if guarded_status_update(self.kube, obj, refresh):
                pruned += 1
        return pruned

    def _status_entries(self, violations: list) -> list:
        """The capped, truncated violation entries a status write
        publishes for this violation set. None-valued fields are
        OMITTED, not written as nulls: a real apiserver's structural-
        schema pruning drops nulls on write, and the skip-unchanged
        comparison must match what reads back."""
        entries = []
        for r in violations[: self.limit]:
            res = r.resource or {}
            meta = res.get("metadata") or {}
            msg = r.msg
            if len(msg.encode()) > MSG_SIZE_LIMIT:
                msg = msg.encode()[:MSG_SIZE_LIMIT].decode("utf-8",
                                                           "ignore")
            entry = {
                "message": msg,
                "enforcementAction": r.enforcement_action,
                "kind": res.get("kind"),
                "name": meta.get("name"),
                "namespace": meta.get("namespace"),
            }
            entries.append({k: v for k, v in entry.items()
                            if v is not None})
        return entries

    def _update_constraint_status(self, obj: dict, entries: list,
                                  total: int) -> bool:
        status = obj.setdefault("status", {})
        status["auditTimestamp"] = time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        status["totalViolations"] = total
        status["violations"] = entries
        from .resilience import guarded_status_update

        def refresh(cur_obj):
            try:
                meta = cur_obj.get("metadata") or {}
                cur = self.kube.get(
                    (CONSTRAINT_GROUP, "v1beta1", cur_obj.get("kind")),
                    meta.get("name") or "")
            except KubeError:
                return None
            # a conflict means another writer landed first: overlay
            # this sweep's keys on the live status and keep the rest
            # (the controllers' byPod)
            live = dict(cur.get("status") or {})
            live.update((k, status[k]) for k in AUDIT_STATUS_KEYS)
            cur["status"] = live
            return cur

        # shared breaker-aware protocol: breaker refusals and guarded-
        # client transients return immediately (the next sweep's delta
        # comparison re-issues the write); only Conflicts refresh-retry
        return guarded_status_update(self.kube, obj, refresh)


# ------------------------------------------------------- sharded inventory

def _review_sort_key(review: Optional[dict]) -> list:
    """The driver's review ordering key (client/drivers.py builds
    inventory reviews cluster-scoped first, then namespaced, each
    sorted (ns, group/version, kind, name)) — recomputed from the
    review dict so per-shard result runs carry a merge key that
    interleaves bit-equal with the unsharded order."""
    review = review or {}
    rk = review.get("kind") or {}
    group = rk.get("group") or ""
    version = rk.get("version") or ""
    gv = f"{group}/{version}" if group else version
    ns = review.get("namespace")
    if ns:
        return [1, ns, gv, rk.get("kind") or "", review.get("name") or ""]
    return [0, "", gv, rk.get("kind") or "", review.get("name") or ""]


def _result_to_wire(r: Result) -> dict:
    """JSON-able Result: the shard materialized messages and ran the
    target's violation handler already, so `resource` travels populated
    and the leader never re-derives anything."""
    return {"msg": r.msg, "metadata": thaw(r.metadata) or {},
            "constraint": thaw(r.constraint), "review": thaw(r.review),
            "resource": thaw(r.resource),
            "enforcement_action": r.enforcement_action}


def _result_from_wire(d: dict) -> Result:
    return Result(msg=d.get("msg") or "", metadata=d.get("metadata") or {},
                  constraint=d.get("constraint"), review=d.get("review"),
                  resource=d.get("resource"),
                  enforcement_action=d.get("enforcement_action") or "deny")


def compose_shard_results(per_shard: dict, writer=None,
                          target: str = "admission.k8s.gatekeeper.sh"
                          ) -> list:
    """Merge per-shard sweep payloads into ONE ordered result list,
    bit-equal to the unsharded sweep. Kinds iterate sorted (the
    driver's template-kind-major order); within a kind each shard's
    run is already review-major in review sort order (every audit path
    — delta-serve, device consume, interpreter — emits row-major), so
    a heap-merge on the review key interleaves them exactly. A review's
    rows live on ONE shard (consistent hash of (GVK, namespace)), so
    ties never span shards and the merge is a true interleave, never a
    reorder. Composed kinds feed `writer.on_kind` as they finish so
    streamed status writes overlap the remaining merge."""
    kinds = sorted({k for p in per_shard.values()
                    for k in (p.get("kinds") or {})})
    out: list = []
    for kind in kinds:
        runs = [(p.get("kinds") or {}).get(kind) or []
                for _, p in sorted(per_shard.items())]
        merged = heapq.merge(*runs, key=lambda e: tuple(e[0]))
        kr = [_result_from_wire(e[1]) for e in merged]
        if writer is not None:
            writer.on_kind(target, kind, kr)
        out.extend(kr)
    return out


class AuditSliceServer:
    """The shard-process end of the sharded audit plane: serves
    /v1/auditslice on an audit engine's backplane socket. One request =
    one capped sweep of THIS process's slice — the driver's review
    filter (set_audit_shard) scopes candidates to owned objects while
    broadcast copies stay visible to joins — returning per-kind result
    runs keyed for the leader's bit-equal merge."""

    def __init__(self, client, shard_id: int = 0, shard_count: int = 1,
                 ready: Optional[Callable[[], bool]] = None):
        self.client = client
        self.shard_id = shard_id
        self.shard_count = shard_count
        # armed by the engine to the library sink's synced flag: a
        # freshly respawned shard must answer 503 (leader retries after
        # the supervisor's slice resync), never an empty-library sweep
        # that would silently drop this partition's violations
        self.ready = ready

    def handle_http(self, body: bytes) -> tuple:
        try:
            req = json.loads(body or b"{}")
        except ValueError:
            return 400, b'{"error":"bad json"}'
        if (req.get("op") or "sweep") != "sweep":
            return 400, b'{"error":"unknown op"}'
        if self.ready is not None and not self.ready():
            return 503, b'{"error":"shard not synced"}'
        cap = req.get("cap")
        driver = getattr(self.client, "driver", None)
        cap_armed = hasattr(driver, "audit_violations_cap")
        if cap_armed:
            driver.audit_violations_cap = cap
        t0 = time.monotonic()
        try:
            results = self.client.audit().results()
        finally:
            if cap_armed:
                driver.audit_violations_cap = None
        eval_s = time.monotonic() - t0
        kinds: dict = {}
        for r in results:
            kind = (r.constraint or {}).get("kind") or ""
            kinds.setdefault(kind, []).append(
                [_review_sort_key(r.review), _result_to_wire(r)])
        n_reviews = 0
        try:
            n_reviews = len(driver._inventory_reviews(
                "admission.k8s.gatekeeper.sh"))
        except Exception:
            pass
        out = {"shard": self.shard_id, "kinds": kinds,
               "stats": {"violations": len(results),
                         "reviews": n_reviews,
                         "eval_s": round(eval_s, 4)}}
        return 200, json.dumps(out).encode("utf-8")


class ShardedAuditPlane:
    """Leader-side orchestration of the sharded audit inventory.

    Consistent-hashes the auditable inventory by (GVK, namespace)
    across N audit engine processes (an AuditShardSupervisor's
    children). Each shard owns its slice end to end — the encoded
    feature rows, delta cache and incremental-sweep state live in that
    process, scoped by its driver's review filter — while the leader:

      * runs one InventoryTracker per shard over a ScopedKube view, so
        watches, resume RVs and the (uid, rv) state map persist per
        slice (and snapshot/restore per slice);
      * applies every delta to its OWN full-inventory client too
        (admission and preview still serve the whole cluster) and,
        riding the client's on_change notifications, routes the object
        to its owner shard plus a column-PRUNED broadcast copy to every
        other shard when the kind can be a join partner (the driver's
        audit_broadcast_spec — the sik join-key columns);
      * dispatches per-shard sweeps over the backplane and composes
        the per-kind runs into one bit-equal audit round;
      * rides shard death on the supervisor's respawn + per-shard sync
        (the slice rebuilds from the leader's tree) and re-sweeps ONLY
        the orphaned partition — the surviving shards' runs are
        already in hand.
    """

    TARGET = "admission.k8s.gatekeeper.sh"

    def __init__(self, kube, opa: Client, supervisor, shard_count: int,
                 vnodes: int = 64, sweep_timeout_s: float = 600.0):
        from .shardmap import ShardMap

        self.kube = kube
        self.opa = opa
        self.supervisor = supervisor
        self.shard_count = int(shard_count)
        self.map = ShardMap(self.shard_count, vnodes=vnodes)
        self.sweep_timeout_s = sweep_timeout_s
        self._stop = threading.Event()
        self._bcast: tuple = (None, None)  # (cache key, spec)
        self.trackers = [
            InventoryTracker(ScopedKube(kube, self._owns_pred(k)), opa)
            for k in range(self.shard_count)]
        metrics.report_audit_shard_map(self.map.version,
                                       self.shard_count)

    def _owns_pred(self, k: int) -> Callable:
        return lambda gvk, ns, _k=k: self.map.owner(gvk, ns) == _k

    def stop(self) -> None:
        self._stop.set()
        for t in self.trackers:
            t.stop()

    # ------------------------------------------------------- replication

    def attach(self) -> None:
        """Chain onto the leader client's on_change feed: data deltas
        route to their owner shard (+ the broadcast set), every other
        library op replicates to ALL shards (each shard's client
        evaluates the full template/constraint library over its
        slice). Chained, not replaced — the admission-engine fan-out
        installed before us keeps firing."""
        prev = self.opa.on_change

        def fan_out(op, obj, _prev=prev):
            if _prev is not None:
                _prev(op, obj)
            self.on_library_change(op, obj)

        self.opa.on_change = fan_out

    def on_library_change(self, op: str, obj) -> None:
        if self.supervisor is None:
            return
        if op == "add_data":
            self.route_add(obj)
        elif op == "remove_data":
            self.route_remove(obj)
        else:
            # template/constraint/mutator ops invalidate the broadcast
            # column spec (a new join template can widen it) and
            # replicate everywhere
            self._bcast = (None, None)
            self.supervisor.replicate(op, obj)

    def broadcast_spec(self) -> dict:
        """Join-relevant column spec from the leader driver, cached
        until a library (non-data) change invalidates it; the template-
        kind set double-keys the cache against restores that bypass
        on_change."""
        driver = getattr(self.opa, "driver", None)
        try:
            key = tuple(sorted(self.opa.template_kinds()))
        except Exception:
            key = None
        cached_key, spec = self._bcast
        if spec is not None and cached_key == key:
            return spec
        if hasattr(driver, "audit_broadcast_spec"):
            spec = driver.audit_broadcast_spec()
        else:
            # a driver that cannot prove column sets degrades to
            # whole-inventory broadcast: sharding must never change a
            # verdict
            spec = {"full": True, "kinds": {}}
        self._bcast = (key, spec)
        return spec

    _NO_BCAST = object()

    def _bcast_cols(self, kind: str):
        """Column subtrees a non-owner shard's copy of `kind` must
        carry: None = whole object, _NO_BCAST = not a join partner
        (owner-only), else a list of path tuples (kind-specific and
        wildcard-join columns unioned)."""
        spec = self.broadcast_spec()
        if spec.get("full"):
            return None
        kinds = spec.get("kinds") or {}
        entries = []
        if kind in kinds:
            entries.append(kinds[kind])
        if "*" in kinds:
            entries.append(kinds["*"])
        if not entries:
            return self._NO_BCAST
        cols: list = []
        for e in entries:
            if e is None:
                return None
            for c in e:
                if tuple(c) not in cols:
                    cols.append(tuple(c))
        return cols

    @staticmethod
    def _prune(obj: dict, cols: list) -> dict:
        """Broadcast skeleton: identity + the join-key column subtrees.
        Labels ride along (namespaceSelector / label joins read them);
        resourceVersion keeps shard-side (uid, rv) no-op dedupe
        working."""
        meta = obj.get("metadata") or {}
        out_meta = {k: v for k, v in
                    (("name", meta.get("name")),
                     ("namespace", meta.get("namespace")),
                     ("uid", meta.get("uid")),
                     ("resourceVersion", meta.get("resourceVersion")),
                     ("labels", meta.get("labels")))
                    if v is not None}
        out = {"apiVersion": obj.get("apiVersion"),
               "kind": obj.get("kind"), "metadata": out_meta}
        for path in cols:
            src: Any = obj
            ok = True
            for seg in path:
                if isinstance(src, dict) and seg in src:
                    src = src[seg]
                else:
                    ok = False
                    break
            if not ok:
                continue
            dst = out
            for seg in path[:-1]:
                nxt = dst.get(seg)
                if not isinstance(nxt, dict):
                    nxt = {}
                    dst[seg] = nxt
                dst = nxt
            dst[path[-1]] = src
        return out

    def route_add(self, obj: dict) -> None:
        from .kube import gvk_of

        sup = self.supervisor
        if sup is None:
            return
        gvk = gvk_of(obj)
        owner = self.map.owner_of_obj(gvk, obj)
        sup.send(owner, {"op": "add_data", "obj": obj})
        cols = self._bcast_cols(obj.get("kind") or "")
        if cols is self._NO_BCAST:
            return
        pruned = obj if cols is None else self._prune(obj, cols)
        for k in range(self.shard_count):
            if k != owner:
                sup.send(k, {"op": "add_data", "obj": pruned})

    def route_remove(self, obj: dict) -> None:
        from .kube import gvk_of

        sup = self.supervisor
        if sup is None:
            return
        gvk = gvk_of(obj)
        owner = self.map.owner_of_obj(gvk, obj)
        sup.send(owner, {"op": "remove_data", "obj": obj})
        if self._bcast_cols(obj.get("kind") or "") is self._NO_BCAST:
            return
        for k in range(self.shard_count):
            if k != owner:
                # removing a never-broadcast copy is a no-op shard-side
                # (delete_data of a missing path returns False)
                sup.send(k, {"op": "remove_data", "obj": obj})

    # ------------------------------------------------------ sync snapshot

    def sync_snapshot(self, shard: int) -> dict:
        """The supervisor's per-shard resync payload: full library +
        this shard's inventory slice REBUILT from the leader's tree
        (owned objects whole, join partners pruned) — a respawned
        shard heals without any cluster re-list; the tracker state
        never left the leader."""
        op = {"op": "sync", "library": self.opa.snapshot_library(),
              "mutators": []}
        driver = getattr(self.opa, "driver", None)
        tree = driver.inventory_snapshot() \
            if hasattr(driver, "inventory_snapshot") else None
        op["data"] = self._prune_tree_for(shard, tree) if tree else None
        return op

    def _prune_tree_for(self, shard: int, tree: dict) -> dict:
        from .kube import gvk_of

        out: dict = {}
        for target, scopes in tree.items():
            if not isinstance(scopes, dict):
                continue
            t_out: dict = {}
            for scope, sub in scopes.items():
                if scope == "cluster":
                    buckets = [("", sub)]
                elif scope == "namespace" and isinstance(sub, dict):
                    buckets = list(sub.items())
                else:
                    continue
                for ns, by_gv in buckets:
                    if not isinstance(by_gv, dict):
                        continue
                    for gv, by_kind in by_gv.items():
                        if not isinstance(by_kind, dict):
                            continue
                        for kind, by_name in by_kind.items():
                            if not isinstance(by_name, dict):
                                continue
                            group, _, version = gv.rpartition("/")
                            gvk = (group, version, kind)
                            owned = self.map.owner(gvk, ns) == shard
                            cols = None if owned \
                                else self._bcast_cols(kind)
                            if cols is self._NO_BCAST:
                                continue
                            for name, o in by_name.items():
                                if not isinstance(o, dict):
                                    continue
                                keep = o if (owned or cols is None) \
                                    else self._prune(o, cols)
                                if scope == "cluster":
                                    dst = t_out.setdefault(
                                        "cluster", {}).setdefault(
                                        gv, {}).setdefault(kind, {})
                                else:
                                    dst = t_out.setdefault(
                                        "namespace", {}).setdefault(
                                        ns, {}).setdefault(
                                        gv, {}).setdefault(kind, {})
                                dst[name] = keep
            out[target] = t_out
        return out

    # ----------------------------------------------------------- tracking

    def apply_pending(self) -> dict:
        agg = {"dirty": 0, "total": 0, "event_ts": []}
        for k, t in enumerate(self.trackers):
            st = t.apply_pending()
            agg["dirty"] += st["dirty"]
            agg["total"] += st["total"]
            agg["event_ts"].extend(st.get("event_ts") or [])
            metrics.report_audit_shard_ownership(k, st["total"])
        return agg

    def full_resync(self, gvks: list) -> dict:
        driver = getattr(self.opa, "driver", None)
        if hasattr(driver, "drop_inventory_caches"):
            driver.drop_inventory_caches()
        agg = {"dirty": 0, "total": 0, "event_ts": []}
        for k, t in enumerate(self.trackers):
            st = t.full_resync(gvks)
            agg["dirty"] += st["dirty"]
            agg["total"] += st["total"]
            metrics.report_audit_shard_ownership(k, st["total"])
        return agg

    # -------------------------------------------------------- warm restart

    def snapshot_state(self) -> dict:
        return {"shard_count": self.shard_count,
                "map_version": self.map.version,
                "shards": [t.snapshot() for t in self.trackers]}

    def restore_state(self, snap: Optional[dict]) -> int:
        """Per-slice warm restore. A snapshot taken under a DIFFERENT
        shard count is discarded (cold start): the hash ring moved, so
        the saved slices no longer line up with the live predicates —
        restoring watches against the wrong slice would silently leak
        objects between shards."""
        snap = snap or {}
        shards = snap.get("shards")
        if not shards or snap.get("shard_count") != self.shard_count \
                or len(shards) != self.shard_count:
            if shards:
                log.info("audit shard snapshot discarded (shard count "
                         "changed)",
                         details={"snapshot": snap.get("shard_count"),
                                  "configured": self.shard_count})
            return 0
        n = 0
        for t, s in zip(self.trackers, shards):
            n += t.restore(s)
        return n

    def restore_ready(self) -> bool:
        return all(t.validated.is_set() for t in self.trackers)

    # --------------------------------------------------------- rebalancing

    def rebalance(self, shard_count: int) -> dict:
        """Recompute the hash ring for a new shard count and report how
        much of the tracked inventory moved (the consistent-hashing
        contract: ~|new-old|/max(new,old), not ~all of it). The caller
        owns restarting the supervisor with the matching process count;
        trackers are rebuilt cold — their slices no longer match."""
        keys = set()
        for t in self.trackers:
            with t._lock:
                keys.update((k[0], k[1]) for k in t._state)
        for t in self.trackers:
            t.stop()
        stats = self.map.rebalance(shard_count, sorted(keys))
        self.shard_count = int(shard_count)
        self.trackers = [
            InventoryTracker(ScopedKube(self.kube, self._owns_pred(k)),
                             self.opa)
            for k in range(self.shard_count)]
        metrics.report_audit_shard_map(self.map.version,
                                       self.shard_count)
        metrics.report_audit_shard_rebalanced(stats["moved"])
        log.info("audit shard map rebalanced",
                 details={"shards": self.shard_count, **stats})
        return stats

    # -------------------------------------------------------------- sweeps

    def sweep(self, cap: Optional[int], writer=None,
              heartbeat: Optional[Callable[[], None]] = None
              ) -> tuple[list, dict]:
        """One composed audit round: every shard sweeps its slice
        concurrently; a shard that dies mid-sweep is retried alone
        after the supervisor's respawn + slice resync (the surviving
        shards' runs are kept). Returns (results, stats)."""
        body = json.dumps({"op": "sweep", "cap": cap}).encode("utf-8")
        per_shard: dict = {}
        resweeps = [0] * self.shard_count
        errors: list = []
        lock = threading.Lock()

        def one(k: int) -> None:
            deadline = time.monotonic() + self.sweep_timeout_s
            while True:
                try:
                    status, out = self.supervisor.sweep(
                        k, body,
                        timeout_s=max(1.0,
                                      deadline - time.monotonic()))
                    if status != 200:
                        raise KubeError(
                            f"shard {k} sweep HTTP {status}: "
                            f"{out[:200]!r}")
                    payload = json.loads(out.decode("utf-8"))
                    with lock:
                        per_shard[k] = payload
                    if heartbeat is not None:
                        heartbeat()
                    return
                except Exception as e:
                    if self._stop.is_set() or \
                            time.monotonic() >= deadline:
                        with lock:
                            errors.append((k, e))
                        return
                    # the supervisor's monitor respawns the child and
                    # restores its slice from sync_snapshot; only THIS
                    # partition re-sweeps
                    resweeps[k] += 1
                    metrics.report_audit_shard_resync(k)
                    log.warning("audit shard sweep failed; waiting "
                                "for respawn + slice resync",
                                details={"shard": k, "error": str(e)})
                    if heartbeat is not None:
                        heartbeat()
                    self._stop.wait(0.5)

        threads = [threading.Thread(target=one, args=(k,),
                                    name=f"audit-shard-sweep-{k}",
                                    daemon=True)
                   for k in range(self.shard_count)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            k, e = errors[0]
            raise KubeError(f"audit shard {k} sweep failed after "
                            f"retries: {e}")
        eval_max = 0.0
        violations = 0
        for k in sorted(per_shard):
            st = (per_shard[k].get("stats") or {})
            eval_s = float(st.get("eval_s") or 0.0)
            eval_max = max(eval_max, eval_s)
            violations += int(st.get("violations") or 0)
            metrics.report_audit_shard_sweep(
                k, eval_s, int(st.get("reviews") or 0))
        results = compose_shard_results(per_shard, writer=writer,
                                        target=self.TARGET)
        stats = {"shard_eval_max_s": round(eval_max, 4)}
        if any(resweeps):
            stats["shard_resweeps"] = sum(resweeps)
        return results, stats
