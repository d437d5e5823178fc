"""Kubernetes API access: protocol, in-memory fake, REST client.

The control plane (controllers/audit/webhook/certs) talks to this seam
only. `FakeKube` is the test double standing in for envtest (SURVEY.md §4
tier 3: the reference boots etcd+apiserver; here an in-memory apiserver
model with watch streams gives the same reconciler-level coverage without
binaries). `RestKubeClient` is the production path (kubeconfig/in-cluster
service account against the real API server).

Objects are unstructured dicts. GVKs are (group, version, kind) tuples;
resources are addressed by (gvk, namespace, name).
"""

from __future__ import annotations

import copy
import json
import os
import random
import ssl
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Any, Callable, Optional

GVK = tuple  # (group, version, kind)


class KubeError(Exception):
    """code carries the HTTP status when one applies (str(e) stays the
    plain message — log call sites render details=str(e))."""

    def __init__(self, message: str = "", code: Optional[int] = None):
        super().__init__(message)
        self.code = code

    def __str__(self) -> str:
        return self.args[0] if self.args else ""


class Conflict(KubeError):
    pass


class NotFound(KubeError):
    pass


@dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    object: dict


def gvk_of(obj: dict) -> GVK:
    api_version = obj.get("apiVersion") or ""
    group, _, version = api_version.rpartition("/")
    return (group, version, obj.get("kind") or "")


def _key(obj: dict) -> tuple:
    meta = obj.get("metadata") or {}
    return (meta.get("namespace") or "", meta.get("name") or "")


class FakeKube:
    """In-memory cluster: CRUD + watch streams + discovery.

    Thread-safe; watch subscribers get events through callback queues the
    watch manager drains. Maintains resourceVersion counters and performs
    conflict detection on update, mirroring apiserver semantics the
    reconcilers rely on (retry loops, status subresource).
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._store: dict[GVK, dict[tuple, dict]] = {}
        self._rv = 0
        self._compacted_rv = 0  # resume floor: older RVs must relist
        # deletion tombstones (rv, gvk, obj): a watch resuming from a
        # valid RV must replay deletes that happened while the client
        # was down, exactly as a real apiserver's event history does.
        # Bounded; trimming advances the compaction floor so resumes
        # older than the retained history take the relist path.
        self._deleted: list[tuple] = []
        self._watchers: dict[GVK, list[Callable[[WatchEvent], None]]] = {}
        # discovery: gvk -> {"namespaced": bool, "verbs": [...]}
        self._discovery: dict[GVK, dict] = {}
        # mutation/list call log, for tests asserting API write counts
        # (e.g. the audit's delta'd status PATCHes). Bounded: --fake-kube
        # also backs long-running dev control planes, which must not
        # accumulate one tuple per API call forever
        self.calls: list[tuple] = []

    _CALL_LOG_CAP = 100_000

    # watch(resource_version=...) settles SYNCHRONOUSLY: by the time it
    # returns, the replay was delivered and on_gap (if due) has fired.
    # The tracker's warm-restart validation trusts such resumes without
    # a list-diff; asynchronous clients (the REST streamer, whose 410
    # arrives a round-trip later) must leave this False so restored
    # state is re-validated against a live list instead.
    watch_resume_synchronous = True

    def _record(self, call: tuple) -> None:
        if len(self.calls) >= self._CALL_LOG_CAP:
            del self.calls[: self._CALL_LOG_CAP // 2]
        self.calls.append(call)

    # ------------------------------------------------------------ discovery

    def register_kind(self, gvk: GVK, namespaced: bool = True,
                      listable: bool = True) -> None:
        with self._lock:
            verbs = ["get", "create", "update", "delete", "watch"]
            if listable:
                verbs.append("list")
            self._discovery[gvk] = {"namespaced": namespaced, "verbs": verbs}

    def server_preferred_resources(self) -> list[dict]:
        """Discovery listing (reference audit manager.go:195-229)."""
        with self._lock:
            out = []
            for (g, v, k), info in self._discovery.items():
                out.append({"group": g, "version": v, "kind": k,
                            "namespaced": info["namespaced"],
                            "verbs": list(info["verbs"])})
            return out

    # ---------------------------------------------------------------- CRUD

    def _bump(self) -> str:
        self._rv += 1
        return str(self._rv)

    def create(self, obj: dict) -> dict:
        with self._lock:
            gvk = gvk_of(obj)
            self._record(("create", gvk, _key(obj)))
            bucket = self._store.setdefault(gvk, {})
            key = _key(obj)
            if key in bucket:
                raise Conflict(f"{gvk} {key} already exists")
            stored = copy.deepcopy(obj)
            stored.setdefault("metadata", {})["resourceVersion"] = self._bump()
            bucket[key] = stored
        # notify OUTSIDE the lock: subscribers (watch manager fan-out) take
        # their own locks and may call back into this client — holding our
        # lock here is a lock-order inversion with WatchManager._lock
        self._notify(gvk, WatchEvent("ADDED", copy.deepcopy(stored)))
        return copy.deepcopy(stored)

    def get(self, gvk: GVK, name: str, namespace: str = "") -> dict:
        with self._lock:
            obj = self._store.get(tuple(gvk), {}).get((namespace, name))
            if obj is None:
                raise NotFound(f"{gvk} {namespace}/{name}")
            return copy.deepcopy(obj)

    def update(self, obj: dict, subresource: str = "") -> dict:
        with self._lock:
            gvk = gvk_of(obj)
            self._record(("update", gvk, _key(obj), subresource))
            bucket = self._store.setdefault(gvk, {})
            key = _key(obj)
            cur = bucket.get(key)
            if cur is None:
                raise NotFound(f"{gvk} {key}")
            rv = (obj.get("metadata") or {}).get("resourceVersion")
            cur_rv = (cur.get("metadata") or {}).get("resourceVersion")
            if rv is not None and rv != cur_rv:
                raise Conflict(f"{gvk} {key}: resourceVersion {rv} != {cur_rv}")
            stored = copy.deepcopy(obj)
            if subresource == "status":
                # status updates only touch .status
                merged = copy.deepcopy(cur)
                merged["status"] = copy.deepcopy(obj.get("status"))
                stored = merged
            stored.setdefault("metadata", {})["resourceVersion"] = self._bump()
            bucket[key] = stored
        self._notify(gvk, WatchEvent("MODIFIED", copy.deepcopy(stored)))
        return copy.deepcopy(stored)

    def apply(self, obj: dict) -> dict:
        """create-or-update convenience."""
        try:
            return self.create(obj)
        except Conflict:
            meta = obj.setdefault("metadata", {})
            cur = self.get(gvk_of(obj), meta.get("name") or "",
                           meta.get("namespace") or "")
            meta["resourceVersion"] = cur["metadata"]["resourceVersion"]
            return self.update(obj)

    _DELETE_LOG_CAP = 10_000

    def delete(self, gvk: GVK, name: str, namespace: str = "") -> None:
        with self._lock:
            self._record(("delete", tuple(gvk), (namespace, name)))
            bucket = self._store.get(tuple(gvk), {})
            obj = bucket.pop((namespace, name), None)
            if obj is None:
                raise NotFound(f"{gvk} {namespace}/{name}")
            # tombstone at its own RV (apiserver semantics): resumed
            # watches replay it; trimming moves the compaction floor so
            # resumes predating retained history must relist instead
            self._deleted.append((int(self._bump()), tuple(gvk),
                                  copy.deepcopy(obj)))
            if len(self._deleted) > self._DELETE_LOG_CAP:
                cut = len(self._deleted) // 2
                self._compacted_rv = max(self._compacted_rv,
                                         self._deleted[cut - 1][0])
                del self._deleted[:cut]
        self._notify(tuple(gvk), WatchEvent("DELETED", copy.deepcopy(obj)))

    def list(self, gvk: GVK, namespace: Optional[str] = None) -> list[dict]:
        # apiserver-flap chaos: kube.list simulates the control plane's
        # read path degrading — 410 storms (compaction raced the list),
        # 429 rate limiting, 5xx blips, or a stalled response (sleep).
        # Armed with a rate (kube.list:error:429@0.5) it flaps rather
        # than hard-fails, which is the gray shape real apiservers show.
        from ..utils import faults
        flt = faults.consume("kube.list", gvk=tuple(gvk))
        if flt is not None:
            mode, param = flt
            if mode == "sleep":
                time.sleep(float(param) if param else 1.0)
            else:
                try:
                    code = int(param) if param else 503
                except ValueError:
                    code = 503
                raise KubeError(
                    f"injected apiserver fault on list ({code})",
                    code=code)
        with self._lock:
            self._record(("list", tuple(gvk), namespace))
            out = []
            for (ns, _), obj in sorted(self._store.get(tuple(gvk), {}).items()):
                if namespace is None or ns == namespace:
                    out.append(copy.deepcopy(obj))
            return out

    # --------------------------------------------------------------- watch

    def compact(self) -> None:
        """Chaos/test helper mirroring etcd compaction: resuming a watch
        from any RV issued before this call behaves like a 410 Gone —
        the full relist-style replay instead of a delta resume."""
        with self._lock:
            self._compacted_rv = self._rv

    def watch(self, gvk: GVK, callback: Callable[[WatchEvent], None],
              send_initial: bool = True, resource_version: str = "",
              on_gap: Optional[Callable[[], None]] = None) -> Callable[[], None]:
        """Subscribe; returns an unsubscribe fn. With send_initial, current
        objects are delivered as ADDED first (informer list+watch).

        With resource_version, delivery RESUMES from that point: the
        deletion tombstones and current objects newer than the RV replay
        (DELETED first, then MODIFIED — so a delete-then-recreate lands
        in the right final state) and nothing else — a restart that
        persisted its RV sees no duplicate ADDED storm and misses no
        delete. An RV older than the compaction floor (compact(), or
        tombstone trimming) takes the 410-gap path instead: on_gap fires
        (the subscriber schedules its list-diff reconcile) and every
        live object replays as ADDED for the state map to dedupe."""
        resume: Optional[int] = None
        deletes: list[dict] = []
        changed: list[dict] = []
        if resource_version:
            try:
                resume = int(resource_version)
            except ValueError:
                resume = None
        gap = False
        with self._lock:
            if resume is not None and resume < self._compacted_rv:
                resume = None  # too old: full relist-style replay
                send_initial = True
                gap = True
            elif resume is not None:
                # replay snapshot AND registration under ONE lock hold:
                # store commits happen under this lock, so no event can
                # land between the snapshot and the subscription (a
                # commit before the snapshot is in the replay AND may
                # notify us too — duplicates are (uid, rv) no-ops for
                # the subscriber's state map). Only objects NEWER than
                # the resume point are copied out — the warm-boot fast
                # path must not deep-copy the whole unchanged bucket.
                deletes = [copy.deepcopy(d[2]) for d in self._deleted
                           if d[0] > resume and d[1] == tuple(gvk)]
                for obj in self._store.get(tuple(gvk), {}).values():
                    try:
                        orv = int((obj.get("metadata") or {})
                                  .get("resourceVersion") or 0)
                    except ValueError:
                        orv = resume + 1  # deliver; state map decides
                    if orv > resume:
                        changed.append(copy.deepcopy(obj))
            if resume is not None:
                self._watchers.setdefault(tuple(gvk), []).append(callback)
        if gap and on_gap is not None:
            on_gap()
        if resume is None:
            initial = self.list(gvk) if send_initial else []
            with self._lock:
                self._watchers.setdefault(tuple(gvk),
                                          []).append(callback)
            for obj in initial:
                callback(WatchEvent("ADDED", obj))
        else:
            for obj in deletes:
                callback(WatchEvent("DELETED", obj))
            for obj in changed:
                callback(WatchEvent("MODIFIED", obj))

        def cancel():
            with self._lock:
                subs = self._watchers.get(tuple(gvk), [])
                if callback in subs:
                    subs.remove(callback)

        return cancel

    def _notify(self, gvk: GVK, event: WatchEvent) -> None:
        with self._lock:  # snapshot only; callbacks run outside the lock
            subs = list(self._watchers.get(tuple(gvk), []))
        for cb in subs:
            cb(event)


class ScopedKube:
    """Read view of a kube client restricted to ONE audit shard's slice.

    An ownership predicate over (gvk, namespace) — the consistent-hash
    partition key of the sharded audit plane — filters what `list`
    returns and which watch events reach the subscriber, so the
    InventoryTracker behind this wrapper maintains watches, resume RVs,
    and a (uid, rv) state map for exactly its slice and nothing else.
    Everything the predicate does not govern (discovery, gets, writes,
    `watch_resume_synchronous`, breaker attributes) delegates untouched.

    The resume-RV consequence of filtering: a tracker only advances its
    per-GVK RV from events it was shown, so a resumed watch replays the
    interleaved UNOWNED events again — each filtered out again here.
    Correctness is unaffected; the replay cost is bounded by the
    upstream client's own resume window.
    """

    def __init__(self, inner, owns: Callable[[GVK, str], bool]):
        self.inner = inner
        self.owns = owns

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _admit(self, gvk: GVK, obj: dict) -> bool:
        ns = ((obj or {}).get("metadata") or {}).get("namespace") or ""
        return self.owns(tuple(gvk), ns)

    def list(self, gvk: GVK, namespace: Optional[str] = None) -> list[dict]:
        return [o for o in self.inner.list(gvk, namespace)
                if self._admit(gvk, o)]

    def watch(self, gvk: GVK, callback: Callable[[WatchEvent], None],
              send_initial: bool = True, resource_version: str = "",
              on_gap: Optional[Callable[[], None]] = None
              ) -> Callable[[], None]:
        gvk = tuple(gvk)

        def deliver(event: WatchEvent) -> None:
            if self._admit(gvk, event.object):
                callback(event)

        return self.inner.watch(gvk, deliver, send_initial=send_initial,
                                resource_version=resource_version,
                                on_gap=on_gap)


# --------------------------------------------------------------- REST client


def _plural(kind: str) -> str:
    lower = kind.lower()
    if lower.endswith("s") or lower.endswith("x") or lower.endswith("ch"):
        return lower + "es"
    if lower.endswith("y"):
        return lower[:-1] + "ies"
    return lower + "s"


class RestKubeClient:
    """Minimal apiserver REST client (in-cluster or kubeconfig-less;
    production deployments run in-cluster with the mounted service
    account). Same surface as FakeKube minus watch streaming — the watch
    manager polls list+resourceVersion for this client.

    Reference counterpart: controller-runtime's client + discovery
    (vendored k8s client-go in the reference tree).
    """

    SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

    def __init__(self, base_url: Optional[str] = None,
                 token: Optional[str] = None,
                 ca_file: Optional[str] = None,
                 kubeconfig: Optional[str] = None):
        client_cert: Optional[tuple] = None
        if base_url is None and token is None:
            # precedence: an EXPLICIT kubeconfig (argument or $KUBECONFIG)
            # wins unconditionally; otherwise a mounted in-cluster service
            # account wins over the implicit ~/.kube/config default — a
            # pod must talk to its own apiserver, not whatever cluster a
            # baked-in config file happens to point at
            explicit = kubeconfig or os.environ.get("KUBECONFIG")
            in_cluster = os.path.exists(f"{self.SA_DIR}/token")
            if explicit or not in_cluster:
                cfg = self._load_kubeconfig(kubeconfig)
                if cfg is not None:
                    base_url = cfg.get("server")
                    token = cfg.get("token")
                    ca_file = ca_file or cfg.get("ca_file")
                    client_cert = cfg.get("client_cert")
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        self.base_url = base_url or (f"https://{host}:{port}" if host else
                                     "https://kubernetes.default.svc")
        if token is None and os.path.exists(f"{self.SA_DIR}/token"):
            with open(f"{self.SA_DIR}/token") as f:
                token = f.read().strip()
        self.token = token
        ctx = ssl.create_default_context()
        ca = ca_file or f"{self.SA_DIR}/ca.crt"
        if os.path.exists(ca):
            ctx.load_verify_locations(ca)
        else:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        if client_cert is not None:
            ctx.load_cert_chain(*client_cert)
        self._ssl = ctx
        self._plurals: dict[GVK, tuple[str, bool]] = {}

    @staticmethod
    def _load_kubeconfig(path: Optional[str]) -> Optional[dict]:
        """Minimal kubeconfig reader: current-context's cluster server,
        CA, and user token/client-cert. Inline *-data fields are
        written to temp files (ssl wants paths)."""
        import base64
        import tempfile

        path = path or os.environ.get("KUBECONFIG") or \
            os.path.expanduser("~/.kube/config")
        if not os.path.exists(path):
            return None
        try:
            import yaml

            with open(path) as f:
                cfg = yaml.safe_load(f) or {}
        except Exception:
            return None

        def by_name(section, name):
            for e in cfg.get(section) or []:
                if e.get("name") == name:
                    return e.get(section[:-1]) or {}
            return {}

        def materialize(data_key, file_key, src):
            if src.get(file_key):
                return src[file_key]
            if src.get(data_key):
                import atexit

                f = tempfile.NamedTemporaryFile(delete=False,
                                                suffix=".pem")
                f.write(base64.b64decode(src[data_key]))
                f.close()
                # key material at 0600, removed on exit
                os.chmod(f.name, 0o600)
                atexit.register(lambda p=f.name:
                                os.path.exists(p) and os.unlink(p))
                return f.name
            return None

        try:
            ctx_name = cfg.get("current-context")
            ctx = by_name("contexts", ctx_name)
            cluster = by_name("clusters", ctx.get("cluster"))
            user = by_name("users", ctx.get("user"))
            out: dict = {"server": cluster.get("server")}
            out["ca_file"] = materialize("certificate-authority-data",
                                         "certificate-authority", cluster)
            out["token"] = user.get("token")
            cert = materialize("client-certificate-data",
                               "client-certificate", user)
            key = materialize("client-key-data", "client-key", user)
            if cert and key:
                out["client_cert"] = (cert, key)
        except Exception:
            # an unreadable/corrupt kubeconfig falls back to in-cluster
            # defaults, it must not crash startup
            return None
        return out if out.get("server") else None

    def _open(self, method: str, path: str, body: Any = None,
              timeout: float = 30):
        url = self.base_url + path
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        return urllib.request.urlopen(req, context=self._ssl,
                                      timeout=timeout)

    def _request(self, method: str, path: str, body: Any = None) -> Any:
        # GETs are idempotent: retry transient failures with backoff
        # (client-go's default behavior; a blip must not fail a sweep)
        attempts = 3 if method == "GET" else 1
        for attempt in range(attempts):
            try:
                with self._open(method, path, body) as resp:
                    return json.loads(resp.read() or b"null")
            except urllib.error.HTTPError as e:
                if e.code == 404:
                    raise NotFound(path) from None
                if e.code == 409:
                    raise Conflict(path) from None
                if e.code in (429, 500, 502, 503, 504) and \
                        attempt + 1 < attempts:
                    time.sleep(0.2 * (2 ** attempt))
                    continue
                raise KubeError(f"{method} {path}: HTTP {e.code}",
                                e.code) from None
            except OSError as e:
                if attempt + 1 < attempts:
                    time.sleep(0.2 * (2 ** attempt))
                    continue
                raise KubeError(f"{method} {path}: {e}") from None

    def _resource_path(self, gvk: GVK, namespace: str = "") -> str:
        group, version, kind = gvk
        info = self._plurals.get(tuple(gvk))
        if info is None:
            plural, namespaced = self._discover(gvk)
        else:
            plural, namespaced = info
        prefix = f"/api/{version}" if not group else f"/apis/{group}/{version}"
        if namespaced and namespace:
            return f"{prefix}/namespaces/{namespace}/{plural}"
        return f"{prefix}/{plural}"

    def _discover(self, gvk: GVK) -> tuple[str, bool]:
        group, version, kind = gvk
        path = f"/api/{version}" if not group else f"/apis/{group}/{version}"
        try:
            rl = self._request("GET", path)
            for r in rl.get("resources", []):
                if r.get("kind") == kind and "/" not in r.get("name", ""):
                    out = (r["name"], bool(r.get("namespaced")))
                    self._plurals[tuple(gvk)] = out
                    return out
        except KubeError:
            pass
        out = (_plural(kind), True)
        self._plurals[tuple(gvk)] = out
        return out

    def server_preferred_resources(self) -> list[dict]:
        out = []
        groups = self._request("GET", "/apis").get("groups", [])
        versions = [("", "v1", "/api/v1")]
        for g in groups:
            pv = (g.get("preferredVersion") or {}).get("groupVersion")
            if pv:
                versions.append((g["name"], pv.split("/")[-1], f"/apis/{pv}"))
        for group, version, path in versions:
            try:
                rl = self._request("GET", path)
            except KubeError:
                continue
            for r in rl.get("resources", []):
                if "/" in r.get("name", ""):
                    continue  # subresources
                out.append({"group": group, "version": version,
                            "kind": r.get("kind"),
                            "namespaced": bool(r.get("namespaced")),
                            "verbs": r.get("verbs") or []})
        return out

    def create(self, obj: dict) -> dict:
        meta = obj.get("metadata") or {}
        path = self._resource_path(gvk_of(obj), meta.get("namespace") or "")
        return self._request("POST", path, obj)

    def get(self, gvk: GVK, name: str, namespace: str = "") -> dict:
        return self._request(
            "GET", f"{self._resource_path(gvk, namespace)}/{name}")

    def update(self, obj: dict, subresource: str = "") -> dict:
        meta = obj.get("metadata") or {}
        path = (f"{self._resource_path(gvk_of(obj), meta.get('namespace') or '')}"
                f"/{meta.get('name')}")
        if subresource:
            path += f"/{subresource}"
        return self._request("PUT", path, obj)

    def apply(self, obj: dict) -> dict:
        try:
            return self.create(obj)
        except Conflict:
            meta = obj.setdefault("metadata", {})
            cur = self.get(gvk_of(obj), meta.get("name") or "",
                           meta.get("namespace") or "")
            meta["resourceVersion"] = cur["metadata"]["resourceVersion"]
            return self.update(obj)

    def delete(self, gvk: GVK, name: str, namespace: str = "") -> None:
        self._request(
            "DELETE", f"{self._resource_path(gvk, namespace)}/{name}")

    LIST_PAGE_LIMIT = 500

    def _fill_gvk(self, items: list[dict], gvk: GVK) -> list[dict]:
        group, version, kind = gvk
        api_version = version if not group else f"{group}/{version}"
        for it in items:
            it.setdefault("apiVersion", api_version)
            it.setdefault("kind", kind)
        return items

    def _list_paged(self, gvk: GVK,
                    namespace: str = "") -> tuple[list[dict], str]:
        """Chunked list (?limit + continue tokens) -> (items, list
        resourceVersion) — one giant unpaged list response can stall
        the apiserver on big clusters."""
        base = self._resource_path(gvk, namespace)
        items: list[dict] = []
        cont = ""
        rv = ""
        while True:
            q = f"?limit={self.LIST_PAGE_LIMIT}"
            if cont:
                q += f"&continue={urllib.parse.quote(cont)}"
            rl = self._request("GET", base + q)
            items.extend(rl.get("items") or [])
            meta = rl.get("metadata") or {}
            rv = meta.get("resourceVersion") or rv
            cont = meta.get("continue") or ""
            if not cont:
                break
        return self._fill_gvk(items, gvk), rv

    def list(self, gvk: GVK, namespace: Optional[str] = None) -> list[dict]:
        items, _rv = self._list_paged(gvk, namespace or "")
        return items

    # streamed watches ride long-lived chunked responses; the read
    # timeout must exceed the server's timeoutSeconds or healthy idle
    # streams get cut mid-wait
    WATCH_TIMEOUT_S = 300

    # backoff-relist loop bounds: full jitter on every sleep so an API
    # server blip does not re-synchronize every watcher in the cluster
    # into a thundering re-list herd at t+0.5, t+1, t+2, ...
    WATCH_BACKOFF_BASE_S = 0.5
    WATCH_BACKOFF_CAP_S = 30.0

    def _watch_backoff_wait(self, stop: threading.Event,
                            backoff: float) -> float:
        """Sleep a jittered backoff (uniform in [backoff/2, backoff]);
        returns the next, doubled-and-capped backoff."""
        stop.wait(backoff * (0.5 + random.random() * 0.5))
        return min(backoff * 2, self.WATCH_BACKOFF_CAP_S)

    def watch(self, gvk: GVK, callback, send_initial: bool = True,
              resource_version: str = "", on_gap=None):
        """Streaming watch (?watch=1&resourceVersion=...) with bookmark
        handling and backoff-relist on 410 Gone — client-go informer
        semantics (the dynamiccache fork's underlying ListerWatcher).
        Falls back to poll-and-diff when the server cannot stream
        (e.g. a stub without watch support).

        With resource_version (warm restart: the persisted per-GVK RV),
        the initial paged re-list is SKIPPED and the stream opens at
        that RV — no duplicate ADDED storm for a cluster the caller
        already knows; a successful stream replays everything missed
        while down, deletes included. If the server instead answers 410
        Gone (RV compacted), `on_gap` fires ONCE — the caller schedules
        its own list-diff reconcile for objects deleted in the gap —
        and the standard backoff-relist heals the rest: the diff against
        the empty known-map re-emits every live object and the caller's
        state map dedupes."""
        stop = threading.Event()

        def relist(known: dict, first: bool) -> tuple[dict, str]:
            """Sync state from a fresh list: emit the diff, return the
            new known-map and the list resourceVersion to stream from."""
            items, rv = self._list_paged(gvk)
            seen = {}
            for o in items:
                k = _key(o)
                orv = (o.get("metadata") or {}).get("resourceVersion")
                seen[k] = (orv, o)
                if k not in known:
                    if not first or send_initial:
                        callback(WatchEvent("ADDED", o))
                elif known[k][0] != orv:
                    callback(WatchEvent("MODIFIED", o))
            for k in set(known) - set(seen):
                callback(WatchEvent("DELETED", known[k][1]))
            return seen, rv

        def stream(known: dict, rv: str) -> tuple[dict, str, bool]:
            """One watch connection; returns (known, rv, gone) where
            gone=True means the RV expired (410) and a relist is due."""
            base = self._resource_path(gvk)
            q = (f"?watch=1&allowWatchBookmarks=true"
                 f"&timeoutSeconds={self.WATCH_TIMEOUT_S - 30}"
                 f"&resourceVersion={urllib.parse.quote(rv)}")
            group, version, kind = gvk
            api_version = version if not group else f"{group}/{version}"
            with self._open("GET", base + q,
                            timeout=self.WATCH_TIMEOUT_S) as resp:
                for line in resp:
                    if stop.is_set():
                        return known, rv, False
                    line = line.strip()
                    if not line:
                        continue
                    ev = json.loads(line)
                    etype = ev.get("type")
                    obj = ev.get("object") or {}
                    if etype == "BOOKMARK":
                        rv = (obj.get("metadata") or {}).get(
                            "resourceVersion") or rv
                        continue
                    if etype == "ERROR":
                        if (obj.get("code") == 410
                                or "too old" in str(obj.get("message"))):
                            return known, rv, True
                        raise KubeError(f"watch {gvk}: {obj}")
                    if etype not in ("ADDED", "MODIFIED", "DELETED"):
                        # a server that ignored ?watch=1 (or a corrupt
                        # stream) must resync, not emit junk events
                        raise KubeError(f"watch {gvk}: unexpected "
                                        f"frame {ev!r}")
                    obj.setdefault("apiVersion", api_version)
                    obj.setdefault("kind", kind)
                    k = _key(obj)
                    orv = (obj.get("metadata") or {}).get(
                        "resourceVersion")
                    if etype == "DELETED":
                        known.pop(k, None)
                    else:
                        known[k] = (orv, obj)
                    rv = orv or rv
                    callback(WatchEvent(etype, obj))
            return known, rv, False  # clean server-side timeout close

        def poll_loop(known: dict, first: bool):
            """2s list-and-diff, continuing from the streamed state —
            restarting from empty would duplicate ADDED events and
            never emit DELETED for objects lost in the gap."""
            while not stop.is_set():
                try:
                    known, _rv = relist(known, first)
                    first = False
                except KubeError:
                    pass
                stop.wait(2.0)

        def loop():
            known: dict = {}
            # resume mode: stream straight from the persisted RV (no
            # initial list); first=False so any later gap-heal relist
            # EMITS its diff instead of suppressing it
            first = not resource_version
            rv = resource_version or ""
            need_relist = not resource_version
            # until the resumed stream is confirmed good, any fall into
            # the relist path means events (deletes especially) may have
            # been missed: signal the gap exactly once
            resume_pending = bool(resource_version)
            backoff = self.WATCH_BACKOFF_BASE_S
            bad_frames = 0
            while not stop.is_set():
                try:
                    if need_relist:
                        if resume_pending:
                            resume_pending = False
                            if on_gap is not None:
                                try:
                                    on_gap()
                                except Exception:
                                    pass
                        known, rv = relist(known, first)
                        first = False
                        need_relist = False
                    known, rv, gone = stream(known, rv)
                    backoff = self.WATCH_BACKOFF_BASE_S
                    bad_frames = 0
                    if not gone:
                        resume_pending = False  # server accepted our RV
                    if gone:
                        need_relist = True  # RV expired: resync
                except urllib.error.HTTPError as e:
                    if e.code in (400, 405, 501):
                        # server cannot stream: degrade to polling. A
                        # pending resume dies here — the poll diff
                        # against an empty known-map cannot surface
                        # downtime deletions, so the gap must be
                        # signaled before degrading
                        if resume_pending and on_gap is not None:
                            try:
                                on_gap()
                            except Exception:
                                pass
                        poll_loop(known, first)
                        return
                    need_relist = True
                    backoff = self._watch_backoff_wait(stop, backoff)
                except (KubeError, OSError, ValueError) as e:
                    if isinstance(e, KubeError) and \
                            "unexpected frame" in str(e):
                        # a server answering ?watch=1 with plain lists
                        # can never stream: after a few tries, poll at
                        # the 2s cadence instead of error-backoff
                        bad_frames += 1
                        if bad_frames >= 3:
                            poll_loop(known, first)
                            return
                    need_relist = True
                    backoff = self._watch_backoff_wait(stop, backoff)

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        return stop.set


# ------------------------------------------------------------ leader election


LEASE_GVK = ("coordination.k8s.io", "v1", "Lease")

_LEASE_TIME_FMT = "%Y-%m-%dT%H:%M:%S.%fZ"


def _lease_now() -> str:
    import datetime

    return datetime.datetime.utcnow().strftime(_LEASE_TIME_FMT)


def _lease_parse(ts) -> Optional[float]:
    import calendar
    import datetime

    if not ts:
        return None
    for fmt in (_LEASE_TIME_FMT, "%Y-%m-%dT%H:%M:%SZ"):
        try:
            dt = datetime.datetime.strptime(str(ts), fmt)
            return calendar.timegm(dt.timetuple()) + dt.microsecond / 1e6
        except ValueError:
            continue
    return None


class LeaseElector:
    """`coordination.k8s.io/v1` Lease-based leader election.

    Counterpart of controller-runtime's leaderelection (the reference
    runs its audit and status writers under it, main.go's
    --enable-leader-election): acquire-or-takeover with conflict-safe
    updates, periodic renewal at a fraction of the lease duration,
    jittered retry while another holder is live, and a graceful release
    on stop() so failover costs milliseconds instead of a full lease
    timeout. Leadership transitions are logged, exported via the
    gatekeeper_tpu_leader metric, and delivered to the optional
    callbacks; `is_leader` is the gate the audit loop and the
    GuardedKube write fence consult.

    The `kube.lease` fault point (utils/faults.py) simulates theft
    ("steal": a rival identity takes the lease), lapse ("expire": our
    renews stop landing), and renew API failures ("error")."""

    def __init__(self, kube, lease_name: str = "gatekeeper-tpu-leader",
                 namespace: str = "gatekeeper-system",
                 identity: Optional[str] = None,
                 lease_duration: float = 15.0,
                 retry_period: Optional[float] = None,
                 on_started_leading: Optional[Callable[[], None]] = None,
                 on_stopped_leading: Optional[Callable[[], None]] = None):
        from .util import pod_name

        self.kube = kube
        self.lease_name = lease_name
        self.namespace = namespace
        self.identity = identity or pod_name()
        self.lease_duration = max(0.1, lease_duration)
        self.retry_period = retry_period if retry_period is not None \
            else max(0.05, self.lease_duration / 3.0)
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._leader = threading.Event()
        self._last_renew = 0.0
        # locally-observed renew tracking (client-go's technique): a
        # rival's lease is "expired" only when (holder, renewTime) has
        # not CHANGED for a lease duration on OUR monotonic clock —
        # comparing the holder's wall-clock renewTime directly would
        # turn inter-node clock skew into premature takeover (dual
        # leaders) or delayed failover
        self._observed: Optional[tuple] = None  # (holder, renew_raw, t)
        self.transitions = 0  # local became/lost count, for tests

    # --------------------------------------------------------------- state

    @property
    def is_leader(self) -> bool:
        return self._leader.is_set()

    def wait_leader(self, timeout: Optional[float] = None) -> bool:
        return self._leader.wait(timeout)

    def healthy(self) -> bool:
        """The elector loop is running (readiness surfaces a dead
        elector; NOT being leader is a normal state, not a failure)."""
        return self._thread is None or self._thread.is_alive() or \
            self._stop.is_set()

    def _become(self, leading: bool, why: str) -> None:
        from . import metrics

        was = self._leader.is_set()
        if was == leading:
            return
        if leading:
            self._leader.set()
        else:
            self._leader.clear()
        self.transitions += 1
        metrics.report_leader(leading)
        _lease_log().info(
            "leadership %s" % ("acquired" if leading else "lost"),
            details={"lease": f"{self.namespace}/{self.lease_name}",
                     "identity": self.identity, "reason": why})
        cb = self.on_started_leading if leading else self.on_stopped_leading
        if cb is not None:
            try:
                cb()
            except Exception as e:
                _lease_log().error("leadership callback failed",
                                   details=str(e))

    # --------------------------------------------------------------- lease

    def _lease_stub(self) -> dict:
        return {"apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
                "metadata": {"name": self.lease_name,
                             "namespace": self.namespace}}

    def _tick(self) -> None:
        from ..utils import faults

        fault = faults.consume("kube.lease", identity=self.identity)
        if fault is not None:
            self._apply_fault(fault)
            if fault[0] in ("error", "raise"):
                raise KubeError("injected fault at kube.lease", code=500)
            if fault[0] == "expire":
                # our renews stopped landing: no renew THIS tick — the
                # lapsed lease sits takeable until the next tick, when
                # we re-contend like any other candidate
                return
        try:
            lease = self.kube.get(LEASE_GVK, self.lease_name,
                                  self.namespace)
        except NotFound:
            self._try_create()
            return
        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity") or ""
        renew_raw = spec.get("renewTime")
        duration = float(spec.get("leaseDurationSeconds")
                         or self.lease_duration)
        now = time.monotonic()
        if self._observed is None or \
                self._observed[:2] != (holder, renew_raw):
            self._observed = (holder, renew_raw, now)
        expired = renew_raw is None or \
            now - self._observed[2] > duration
        if holder == self.identity:
            self._renew(lease)
        elif not holder or expired:
            self._takeover(lease)
        else:
            # another holder is live: we are (or just became) a follower
            self._become(False, f"lease held by {holder}")

    def _try_create(self) -> None:
        lease = self._lease_stub()
        lease["spec"] = {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": int(max(1, self.lease_duration)),
            "acquireTime": _lease_now(),
            "renewTime": _lease_now(),
            "leaseTransitions": 0,
        }
        try:
            self.kube.create(lease)
        except Conflict:
            return  # raced another candidate; next tick re-evaluates
        self._last_renew = time.monotonic()
        self._become(True, "lease created")

    def _renew(self, lease: dict) -> None:
        lease["spec"]["renewTime"] = _lease_now()
        lease["spec"]["holderIdentity"] = self.identity
        try:
            self.kube.update(lease)
        except Conflict:
            # someone else wrote the lease: re-read next tick; if we
            # were deposed, the holder check will demote us then
            self._check_renew_deadline()
            return
        except KubeError:
            self._check_renew_deadline()
            return
        self._last_renew = time.monotonic()
        self._become(True, "lease renewed")

    def _takeover(self, lease: dict) -> None:
        spec = lease.setdefault("spec", {})
        spec["holderIdentity"] = self.identity
        spec["leaseDurationSeconds"] = int(max(1, self.lease_duration))
        spec["acquireTime"] = _lease_now()
        spec["renewTime"] = _lease_now()
        spec["leaseTransitions"] = int(spec.get("leaseTransitions") or 0) + 1
        try:
            self.kube.update(lease)  # RV-checked: losers Conflict
        except (Conflict, KubeError):
            return
        self._last_renew = time.monotonic()
        self._become(True, "expired lease taken over")

    # a failing leader steps down at this fraction of the lease
    # duration — STRICTLY before the horizon at which rivals may take
    # over (client-go's renewDeadline < leaseDuration), so fenced
    # writes stop before a new leader's writes can start
    RENEW_DEADLINE_FRACTION = 2.0 / 3.0

    def _check_renew_deadline(self) -> None:
        """A leader whose renews keep failing must step down BEFORE the
        lease it last wrote can lapse for everyone else — stepping down
        only at the full duration would leave a window where a rival
        has legitimately taken over while we still pass the write
        fence."""
        deadline = self.lease_duration * self.RENEW_DEADLINE_FRACTION
        if self.is_leader and \
                time.monotonic() - self._last_renew > deadline:
            self._become(False, "renew deadline exceeded")

    def _apply_fault(self, fault: tuple) -> None:
        mode, param = fault
        if mode == "steal":
            # a rival identity takes the lease out from under us
            thief = param or "chaos-rival"
            try:
                lease = self.kube.get(LEASE_GVK, self.lease_name,
                                      self.namespace)
                lease.setdefault("spec", {}).update({
                    "holderIdentity": thief, "renewTime": _lease_now(),
                    "leaseDurationSeconds":
                        int(max(1, self.lease_duration))})
                self.kube.update(lease)
            except KubeError:
                pass
        elif mode == "expire":
            # our renews stopped landing: the lease lapses and we must
            # step down before anyone else can claim it
            try:
                lease = self.kube.get(LEASE_GVK, self.lease_name,
                                      self.namespace)
                if (lease.get("spec") or {}).get("holderIdentity") == \
                        self.identity:
                    lease["spec"]["renewTime"] = \
                        "1970-01-01T00:00:00.000000Z"
                    self.kube.update(lease)
            except KubeError:
                pass
            self._become(False, "lease expired (injected)")

    # ----------------------------------------------------------- lifecycle

    def start(self) -> None:
        from . import metrics

        # export the initial follower state: a replica that never wins
        # must still emit the gauge, or the sum(is_leader="true") != 1
        # alert cannot tell "no leader" from "no metrics"
        metrics.report_leader(self.is_leader)
        self._thread = threading.Thread(target=self._loop, name="elector",
                                        daemon=True)
        self._thread.start()

    def stop(self, release: bool = True) -> None:
        """Graceful shutdown: release the lease when we hold it so the
        survivor fails over immediately instead of waiting out the
        lease duration (release=False simulates a crash in tests)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if release and self.is_leader:
            try:
                lease = self.kube.get(LEASE_GVK, self.lease_name,
                                      self.namespace)
                if (lease.get("spec") or {}).get("holderIdentity") == \
                        self.identity:
                    lease["spec"]["holderIdentity"] = ""
                    self.kube.update(lease)
            except KubeError as e:
                _lease_log().warning("lease release failed",
                                     details=str(e))
        self._become(False, "shutdown")

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception as e:
                _lease_log().warning("leader election tick failed",
                                     details=str(e))
                self._check_renew_deadline()
            # renew fast while leading; retry jittered while following
            # (full jitter: candidates must not stampede the apiserver
            # in lockstep when a leader dies)
            period = self.retry_period
            if not self.is_leader:
                period *= 0.5 + random.random()
            self._stop.wait(period)


def _lease_log():
    from .logging import logger

    return logger("elector")
