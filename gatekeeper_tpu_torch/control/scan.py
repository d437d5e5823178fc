"""Offline fleet scan: saturate the engine with clusterless manifests.

The "millions of users" traffic shape for shift-left policy: every CI
run of every team scanning its GitOps repo tree, pipeline payload, or
multi-cluster inventory export through the same engine that serves
admission — no cluster attached. Everything below the Driver boundary
is a pure batch evaluator, so the scan problem is a LOADER problem:
keep the bulk paths (`MicroBatcher.submit_many` in-process,
backplane B frames or the pipelined gRPC ``ReviewStream`` cross-
process) fed at device rate from a host-side parse of millions of
YAML/JSON documents.

Pipeline shape (bounded at every hop — a 10M-manifest tree must not
become a 10M-entry list anywhere):

  walk/shard -> N loader processes -> dedupe -> double-buffered feed
  (parse + envelope synth      (content-hash     (batch k+1 encodes
   off the hot path)            tier)             while batch k
                                                  evaluates)
                    -> streaming reporter (JSONL out as each bulk
                       batch returns; verdicts never accumulate)

Dedupe: repo trees repeat identical objects heavily (one base
manifest kustomized into dozens of overlays, chart defaults vendored
per service). The content key is the decision-cache recipe — a
blake2b-16 over the canonical synthesized request minus ``uid``/
``timeoutSeconds`` — computed in the loader processes; only the first
occurrence of a key crosses the wire, later occurrences rejoin that
key's verdict on the way out (outcome="dedup" in the record, so the
report still carries one line per manifest). The rejoin cache is a
bounded LRU: an evicted key simply re-evaluates, correctness does not
depend on the cap.

Verdict shape: every tier normalizes to the webhook's own response
construction (`webhook.verdict_response`), so a scan verdict is
bit-equal to what `/v1/admit` (or a per-manifest ``Client.review``)
would have answered for the same object — the conformance oracle
tests/test_scan.py enforces, dedupe path included.

Exit-code contract (CI):
  0  every manifest scanned, no denials, no error records
  1  at least one deny verdict (policy violations found)
  2  at least one error record (malformed manifest, shed/timeout/
     engine failure for some manifests) — takes precedence over 1
  3  the scan itself could not run (bad arguments, no policies,
     engine unreachable at startup)
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import queue
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Iterable, Iterator, Optional

from . import jsonio, metrics
from .logging import logger

log = logger("scan")

MANIFEST_EXTS = (".yaml", ".yml", ".json")
SCAN_USERNAME = "fleet-scan"
CHUNK = 128          # records per loader->feeder queue item
QUEUE_CHUNKS = 32    # loader queue depth (bounds parsed-but-unfed work)


class ScanFatal(Exception):
    """The scan cannot run/continue at all (exit code 3) — distinct
    from per-manifest error records, which never abort the scan."""


# --------------------------------------------------------------- loading


def synthesize_request(obj: dict) -> dict:
    """One clusterless AdmissionRequest for a raw manifest: the same
    review the API server would have sent for `kubectl create` of this
    object (no uid — per-attempt noise; no namespace sideload — there
    is no cluster to fetch it from)."""
    api = obj.get("apiVersion") or ""
    group, _, version = api.rpartition("/")
    meta = obj.get("metadata") or {}
    req = {
        "uid": "",
        "kind": {"group": group, "version": version,
                 "kind": obj.get("kind") or ""},
        "name": meta.get("name") or "",
        "operation": "CREATE",
        "userInfo": {"username": SCAN_USERNAME},
        "object": obj,
    }
    if meta.get("namespace"):
        req["namespace"] = meta["namespace"]
    return req


def content_key(request: dict) -> str:
    """Dedupe key: the decision-cache request hash recipe
    (webhook.DecisionCache.request_key) — canonical JSON of the
    request minus uid/timeoutSeconds. Duplicated here so loader
    processes never import the serving stack."""
    slim = {k: v for k, v in request.items()
            if k not in ("uid", "timeoutSeconds")}
    return hashlib.blake2b(jsonio.canonical_bytes(slim),
                           digest_size=16).hexdigest()


def is_k8s_manifest(doc: Any) -> bool:
    """A scannable document: apiVersion + kind present (gator's own
    bar). Helm values files, kustomization fragments, CI configs and
    the like fall out here as SKIPPED, not errors."""
    return (isinstance(doc, dict)
            and isinstance(doc.get("apiVersion"), str)
            and bool(doc.get("apiVersion"))
            and isinstance(doc.get("kind"), str)
            and bool(doc.get("kind")))


def walk_tree(root: str) -> tuple[list[str], int]:
    """(manifest file paths, non-manifest files skipped) under `root`,
    sorted for deterministic sharding. Dot-directories (.git, ...)
    are pruned."""
    files: list[str] = []
    skipped = 0
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if not d.startswith("."))
        for fn in sorted(filenames):
            if fn.startswith("."):
                continue
            if fn.lower().endswith(MANIFEST_EXTS):
                files.append(os.path.join(dirpath, fn))
            else:
                skipped += 1
    return files, skipped


def _expand(doc: Any) -> Iterator[Any]:
    """v1 List objects expand to their items (inventory exports and
    `kubectl get -o json` dumps ship them)."""
    if isinstance(doc, dict) and doc.get("kind") == "List" \
            and isinstance(doc.get("items"), list):
        for item in doc["items"]:
            yield item
    else:
        yield doc


def parse_file(path: str) -> Iterator[tuple[str, Any]]:
    """Yield ("ok"|"skip"|"err", payload) per document in one manifest
    file. Multi-doc YAML (``---`` separators) yields one entry per
    document; a parse failure is ONE error entry for the file (the
    stream position past a YAML error is undefined), never a raise."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        yield "err", (f"{path}: unreadable: {e}", path)
        return
    docs: Iterable[Any]
    if path.lower().endswith(".json"):
        try:
            docs = [json.loads(raw)]
        except ValueError as e:
            yield "err", (f"{path}: invalid JSON: {e}", path)
            return
    else:
        try:
            import yaml
        except ImportError:
            yield "err", (f"{path}: pyyaml unavailable in this "
                          "environment", path)
            return
        try:
            docs = list(yaml.safe_load_all(raw))
        except yaml.YAMLError as e:
            yield "err", (f"{path}: invalid YAML: "
                          f"{str(e).splitlines()[0]}", path)
            return
    i = 0
    for top in docs:
        for doc in _expand(top):
            if doc is None:
                continue  # blank document between --- separators
            origin = f"{path}#{i}"
            i += 1
            if not is_k8s_manifest(doc):
                yield "skip", origin
            else:
                yield "ok", (origin, doc)


def parse_jsonl(path: str, shard: int = 0, nshards: int = 1,
                lines: Optional[Iterable[bytes]] = None,
                ) -> Iterator[tuple[str, Any]]:
    """Inventory-export loader: one JSON object per line. Sharding is
    by line number so N loaders split one large export; every loader
    still streams the file (reading is cheap next to parsing)."""
    close = None
    if lines is None:
        try:
            f = open(path, "rb")
        except OSError as e:
            if shard == 0:
                yield "err", (f"{path}: unreadable: {e}", path)
            return
        lines, close = f, f.close
    try:
        for n, line in enumerate(lines):
            if n % nshards != shard:
                continue
            if not line.strip():
                continue
            origin = f"{path}:{n + 1}"
            try:
                doc = json.loads(line)
            except ValueError as e:
                yield "err", (f"{origin}: invalid JSON line: {e}",
                              origin)
                continue
            for item in _expand(doc):
                if not is_k8s_manifest(item):
                    yield "skip", origin
                else:
                    yield "ok", (origin, item)
    finally:
        if close is not None:
            close()


def _records(entries: Iterator[tuple[str, Any]],
             encode: bool) -> Iterator[tuple]:
    """Map parse entries to wire-ready records:
      ("ok", origin, key, request, payload|None)
      ("err", origin, message) / ("skip", origin)
    `encode` pre-serializes the AdmissionReview envelope bytes for the
    backplane tier inside the loader process — the whole point of
    taking parse+synth off the hot path."""
    for state, payload in entries:
        if state == "ok":
            origin, doc = payload
            request = synthesize_request(doc)
            body = None
            if encode:
                body = jsonio.dumps_bytes(
                    {"apiVersion": "admission.k8s.io/v1beta1",
                     "kind": "AdmissionReview", "request": request})
            yield "ok", origin, content_key(request), request, body
        elif state == "skip":
            yield "skip", payload
        else:
            msg, origin = payload
            yield "err", origin, msg


def _loader_entries(fmt: str, paths: list[str], shard: int,
                    nshards: int) -> Iterator[tuple[str, Any]]:
    if fmt == "jsonl":
        for path in paths:
            yield from parse_jsonl(path, shard, nshards)
    else:
        # tree / yaml: `paths` is the pre-walked manifest file list;
        # shard by file index
        for path in paths[shard::nshards]:
            yield from parse_file(path)


def _loader_main(fmt: str, paths: list[str], shard: int, nshards: int,
                 encode: bool, outq) -> None:
    """One loader process: parse this shard, push CHUNK-sized record
    lists onto the bounded queue, then a ("done", shard) sentinel.
    Never imports torch or the serving stack."""
    chunk: list[tuple] = []
    try:
        for rec in _records(_loader_entries(fmt, paths, shard, nshards),
                            encode):
            chunk.append(rec)
            if len(chunk) >= CHUNK:
                outq.put(chunk)
                chunk = []
        if chunk:
            outq.put(chunk)
    finally:
        outq.put(("done", shard))


class LoaderPool:
    """N parallel loader processes (0 = parse inline in the caller's
    thread) feeding one bounded queue of record chunks."""

    def __init__(self, fmt: str, paths: list[str], n: int,
                 encode: bool):
        self.n = max(0, int(n))
        self._inline = None
        self._procs: list = []
        if self.n == 0:
            self._inline = _records(
                _loader_entries(fmt, paths, 0, 1), encode)
            return
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._q = ctx.Queue(maxsize=QUEUE_CHUNKS)
        for k in range(self.n):
            p = ctx.Process(target=_loader_main,
                            args=(fmt, paths, k, self.n, encode,
                                  self._q),
                            daemon=True)
            p.start()
            self._procs.append(p)

    def chunks(self) -> Iterator[list[tuple]]:
        if self._inline is not None:
            chunk: list[tuple] = []
            for rec in self._inline:
                chunk.append(rec)
                if len(chunk) >= CHUNK:
                    yield chunk
                    chunk = []
            if chunk:
                yield chunk
            return
        finished: set = set()
        while len(finished) < self.n:
            try:
                item = self._q.get(timeout=1.0)
            except queue.Empty:
                # a loader that died (OOM, import failure in a broken
                # environment) must surface as an error record, never
                # hang the scan waiting on a sentinel that won't come
                for k, p in enumerate(self._procs):
                    if k in finished or p.exitcode is None:
                        continue
                    try:  # one last drain: exit vs flush can race
                        item = self._q.get(timeout=0.5)
                    except queue.Empty:
                        finished.add(k)
                        yield [("err", f"loader[{k}]",
                                f"loader process {k} died "
                                f"(exit {p.exitcode}) before finishing "
                                "its shard")]
                        continue
                    break
                else:
                    continue
            if isinstance(item, tuple) and item and item[0] == "done":
                finished.add(item[1])
                continue
            yield item

    def close(self) -> None:
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()


# ----------------------------------------------------------------- tiers


def _verdict_from_response(resp: dict) -> dict:
    """Normalize one AdmissionReview `response` object into the scan
    verdict record. Stance answers (shed 429 / timeout 504 / internal
    500) become error records — an unevaluated manifest must not be
    reported as allowed; 403 (deny) and gatekeeper-resource validation
    codes pass through as verdicts."""
    status = resp.get("status") or {}
    code = status.get("code")
    if code in (429, 500, 504):
        return {"error": status.get("message")
                or f"admission status {code}"}
    v: dict = {"allowed": bool(resp.get("allowed"))}
    reason = status.get("reason") or status.get("message")
    if reason:
        v["reason"] = reason
    if resp.get("warnings"):
        v["warnings"] = list(resp["warnings"])
    return v


class InprocTier:
    """In-process feed: records go straight into
    ValidationHandler.handle_bulk — one submit_many enqueue per batch
    against this process's own engine. A 2-thread executor gives the
    double buffer: batch k+1's envelope synth and dedupe overlap batch
    k's device evaluation."""

    name = "inproc"
    wants_bytes = False

    def __init__(self, validation, timeout_s: float):
        from concurrent.futures import ThreadPoolExecutor

        self.validation = validation
        self.timeout_s = timeout_s
        self._pool = ThreadPoolExecutor(max_workers=2,
                                        thread_name_prefix="scan-feed")

    def begin(self, batch: list[tuple]):
        reviews = [{"request": rec[3]} for rec in batch]
        deadline = time.monotonic() + self.timeout_s
        return self._pool.submit(self.validation.handle_bulk, reviews,
                                 deadline)

    def finish(self, token) -> list[dict]:
        return [_verdict_from_response((env or {}).get("response")
                                       or {})
                for env in token.result()]

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        self.validation.batcher.stop()


class BackplaneTier:
    """Cross-process feed over the backplane's length-prefixed B
    frames: pre-serialized AdmissionReview bytes from the loaders go
    out as one vectored frame per batch. review_bulk_begin/finish
    split the round trip so the next batch encodes while this one
    evaluates in the engine process — the double buffer costs no
    thread per in-flight frame."""

    name = "backplane"
    wants_bytes = True

    def __init__(self, socket_path: str, timeout_s: float):
        from .backplane import BackplaneClient, BackplaneError

        self._err_cls = BackplaneError
        self.timeout_s = timeout_s
        self.client = BackplaneClient(
            socket_path, worker_id=f"scan-{os.getpid()}")

    def begin(self, batch: list[tuple]):
        payloads = [rec[4] for rec in batch]
        try:
            return self.client.review_bulk_begin(
                payloads, timeout_s=self.timeout_s)
        except self._err_cls as e:
            return e  # failed batch: finish() maps it to error records

    def finish(self, token) -> list[dict]:
        if isinstance(token, Exception):
            raise token
        return [_verdict_from_response(
                    (jsonio.loads(env) or {}).get("response") or {})
                for env in self.client.review_bulk_finish(token)]

    def close(self) -> None:
        self.client.close()


class GrpcTier:
    """Cross-process feed over the pipelined gRPC ReviewStream: one
    bidirectional HTTP/2 stream, batches pipelined with no per-RPC
    round trip. raw=True skips client-side Responses object
    construction (a million Result dataclasses is pure overhead when
    the next step flattens them to verdict pairs anyway). A mid-stream
    batch error fails every batch still in flight and the stream is
    rebuilt for the remainder of the scan."""

    name = "grpc"
    wants_bytes = False

    def __init__(self, address: str, timeout_s: float):
        from ..service.client import RemoteClient

        self.rc = RemoteClient(address)
        self.timeout_s = timeout_s
        self._resp = None
        self._q: Optional[queue.Queue] = None
        self._out = 0
        self._dead = 0
        self._err = ""

    def _reset(self) -> None:
        self._q = queue.Queue()
        self._resp = self.rc.review_stream(iter(self._q.get, None),
                                           raw=True)

    def begin(self, batch: list[tuple]):
        if self._resp is None:
            self._reset()
        self._out += 1
        self._q.put([rec[3] for rec in batch])
        return batch

    @staticmethod
    def _verdict(wire: dict) -> dict:
        from .webhook import verdict_response

        pairs = []
        for resp in (wire.get("byTarget") or {}).values():
            for r in resp.get("results") or []:
                pairs.append((r.get("enforcementAction") or "deny",
                              r.get("msg") or ""))
        return _verdict_from_response(verdict_response(pairs))

    def finish(self, token) -> list[dict]:
        self._out -= 1
        if self._dead:
            # a prior batch's stream error already doomed this one
            self._dead -= 1
            return [{"error": self._err} for _ in token]
        try:
            wire = next(self._resp)
        except StopIteration:
            wire = None
        except Exception as e:  # per-batch server error or transport
            self._err = f"stream batch failed: {e}"
            self._dead = self._out
            self._resp = None
            return [{"error": self._err} for _ in token]
        if wire is None or len(wire) != len(token):
            self._err = "review stream answered short"
            self._dead = self._out
            self._resp = None
            return [{"error": self._err} for _ in token]
        return [self._verdict(d) for d in wire]

    def close(self) -> None:
        if self._q is not None:
            self._q.put(None)  # ends the request generator
        try:
            for _ in self._resp or ():
                pass
        except Exception:
            pass
        self.rc.close()


# ----------------------------------------------------- dedupe + reporter


class DedupeTier:
    """Content-hash dedupe IN FRONT of the wire (and of the engine's
    decision cache): first occurrence of a key goes out, duplicates
    wait on that key's verdict (rejoined when its batch returns) or
    hit the bounded verdict LRU. size=0 disables."""

    def __init__(self, size: int):
        self.size = max(0, int(size))
        self._verdicts: "OrderedDict[str, dict]" = OrderedDict()
        self._inflight: dict[str, list[str]] = {}
        self.hits = 0

    def check(self, key: str, origin: str) -> Optional[dict]:
        """None -> caller must send this record; a verdict dict ->
        served from cache; ... queued behind an in-flight key returns
        the _PENDING sentinel."""
        if not self.size:
            return None
        v = self._verdicts.get(key)
        if v is not None:
            self._verdicts.move_to_end(key)
            self.hits += 1
            return v
        waiters = self._inflight.get(key)
        if waiters is not None:
            waiters.append(origin)
            self.hits += 1
            return _PENDING
        self._inflight[key] = []
        return None

    def resolve(self, key: str, verdict: dict) -> list[str]:
        """Record the verdict for `key`; returns the origins that were
        queued behind it (the caller emits their records)."""
        if not self.size:
            return []
        waiters = self._inflight.pop(key, [])
        if "error" not in verdict:
            # an error verdict (shed/timeout) must not be replayed to
            # later duplicates — let them re-evaluate
            self._verdicts[key] = verdict
            while len(self._verdicts) > self.size:
                self._verdicts.popitem(last=False)
        return waiters


_PENDING = {"__pending__": True}


class Reporter:
    """Streaming JSONL sink + counters. One line per manifest, written
    as its batch returns — a 10M-manifest scan holds one batch of
    records in memory, never the verdict set."""

    def __init__(self, out):
        self.out = out
        self.counts = {"allow": 0, "deny": 0, "error": 0, "dedup": 0,
                       "skip": 0}
        self.denied = 0
        self.manifests = 0

    def emit(self, origin: str, verdict: dict, outcome: str) -> None:
        rec = {"origin": origin}
        if "error" in verdict:
            outcome = "error"
            rec["error"] = verdict["error"]
        else:
            rec.update(verdict)
            if not verdict.get("allowed"):
                self.denied += 1
        self.counts[outcome] = self.counts.get(outcome, 0) + 1
        if outcome != "skip":
            self.manifests += 1
            rec["outcome"] = outcome
            self.out.write(jsonio.dumps_bytes(rec).decode() + "\n")

    def skip(self, origin: str) -> None:
        self.counts["skip"] += 1

    def flush_metrics(self) -> None:
        for outcome, n in self.counts.items():
            if n:
                metrics.report_scan_manifests(outcome, n)
        # counters, not deltas: flush once at scan end (this process
        # exits with the scan; nothing scrapes mid-run by default)


# ---------------------------------------------------------------- engine


def run_scan(tier, loader: LoaderPool, out, batch_size: int = 256,
             depth: int = 2, dedupe_size: int = 65536,
             ) -> dict:
    """Drive the pipeline to completion; returns the summary dict.
    `tier` is one of the three feed tiers, `loader` an initialized
    LoaderPool, `out` a text stream for JSONL records."""
    rep = Reporter(out)
    dedupe = DedupeTier(dedupe_size)
    inflight: deque = deque()   # (token, [(key, origin), ...])
    batch: list[tuple] = []
    sent_unique = 0
    t_start = time.monotonic()

    def complete_one() -> None:
        token, items = inflight.popleft()
        t0 = time.monotonic()
        try:
            verdicts = tier.finish(token)
        except Exception as e:
            verdicts = [{"error": f"bulk batch failed: {e}"}
                        for _ in items]
        dt = time.monotonic() - t0
        metrics.report_scan_batch(tier.name, dt)
        metrics.report_stage("scan", "scan_feed", dt)
        t1 = time.monotonic()
        if len(verdicts) != len(items):
            verdicts = [{"error": "bulk batch answered short"}
                        for _ in items]
        for (key, origin), verdict in zip(items, verdicts):
            rep.emit(origin, verdict,
                     "error" if "error" in verdict else
                     ("allow" if verdict.get("allowed") else "deny"))
            for dup_origin in dedupe.resolve(key, verdict):
                rep.emit(dup_origin, verdict,
                         "error" if "error" in verdict else "dedup")
        metrics.report_stage("scan", "scan_report",
                             time.monotonic() - t1)

    def flush() -> None:
        nonlocal batch, sent_unique
        if not batch:
            return
        while len(inflight) >= depth:
            complete_one()
        sent_unique += len(batch)
        inflight.append((tier.begin(batch),
                         [(rec[2], rec[1]) for rec in batch]))
        batch = []

    t_wait = time.monotonic()
    for chunk in loader.chunks():
        metrics.report_stage("scan", "scan_load",
                             time.monotonic() - t_wait)
        t0 = time.monotonic()
        for rec in chunk:
            state = rec[0]
            if state == "ok":
                _, origin, key, _request, _body = rec
                hit = dedupe.check(key, origin)
                if hit is None:
                    batch.append(rec)
                elif hit is not _PENDING:
                    rep.emit(origin, hit, "dedup")
            elif state == "skip":
                rep.skip(rec[1])
            else:
                rep.emit(rec[1], {"error": rec[2]}, "error")
        metrics.report_stage("scan", "scan_dedupe",
                             time.monotonic() - t0)
        if len(batch) >= batch_size:
            flush()
        t_wait = time.monotonic()
    flush()
    while inflight:
        complete_one()
    # keys whose first occurrence errored leave waiters behind only if
    # resolve() was never reached — the zip above always reaches it,
    # so every manifest has exactly one record by here
    loader.close()
    wall = time.monotonic() - t_start
    rep.flush_metrics()
    done = rep.manifests
    summary = {
        "tier": tier.name,
        "manifests": done,
        "unique_evaluated": sent_unique,
        "deduped": rep.counts.get("dedup", 0),
        "allowed": rep.counts.get("allow", 0),
        "denied": rep.denied,
        "errors": rep.counts.get("error", 0),
        "skipped_docs": rep.counts.get("skip", 0),
        "wall_s": round(wall, 3),
        "manifests_per_sec": round(done / wall) if wall > 0 else 0,
        "dedupe_hits": dedupe.hits,
    }
    return summary


def exit_code(summary: dict) -> int:
    if summary.get("errors"):
        return 2
    if summary.get("denied"):
        return 1
    return 0


# ------------------------------------------------ in-process policy load


def iter_policy_docs(paths: list[str]) -> Iterator[tuple[str, dict]]:
    for p in paths:
        files = [p]
        if os.path.isdir(p):
            files, _ = walk_tree(p)
        for f in files:
            for state, payload in parse_file(f):
                if state == "err":
                    raise ScanFatal(f"policy source: {payload[0]}")
                if state == "ok":
                    yield payload


def ingest_policies(client, paths: list[str]) -> dict:
    """Load ConstraintTemplates + constraints from files/dirs into the
    scan's private client. Templates ingest before constraints so file
    order never matters."""
    templates, constraints = [], []
    for origin, doc in iter_policy_docs(paths):
        if doc.get("kind") == "ConstraintTemplate":
            templates.append((origin, doc))
        elif str(doc.get("apiVersion", "")).startswith(
                "constraints.gatekeeper.sh"):
            constraints.append((origin, doc))
        # other kinds in a policy dir (e.g. sync configs) are ignored
    for origin, doc in templates:
        try:
            client.add_template(doc)
        except Exception as e:
            raise ScanFatal(f"{origin}: template rejected: {e}") from e
    for origin, doc in constraints:
        try:
            client.add_constraint(doc)
        except Exception as e:
            raise ScanFatal(f"{origin}: constraint rejected: {e}") \
                from e
    return {"templates": len(templates), "constraints": len(constraints)}


def ingest_candidate(client, template: Optional[dict],
                     constraint: dict) -> str:
    """Preview mode: ingest ONE candidate template+constraint under the
    content-hashed alias kind (`<Kind>PV<sha12>`), so candidate
    program identity matches what a server-side /v1/preview of the same
    template content compiles — the program store and Triton's cache
    serve both.
    Returns the alias kind."""
    import copy

    kind = constraint.get("kind") or ""
    if template is not None:
        names = (((template.get("spec") or {}).get("crd") or {})
                 .get("spec") or {}).get("names") or {}
        kind = kind or names.get("kind") or ""
        content = template.get("spec")
        sha = hashlib.sha256(json.dumps(
            content, sort_keys=True,
            default=str).encode()).hexdigest()[:12]
        alias = f"{kind}PV{sha}"
        t2 = copy.deepcopy(template)
        ((t2.setdefault("spec", {}).setdefault("crd", {})
          .setdefault("spec", {}).setdefault("names", {})
          )["kind"]) = alias
        t2.setdefault("metadata", {})["name"] = alias.lower()
        try:
            client.add_template(t2)
        except Exception as e:
            raise ScanFatal(f"candidate template rejected: {e}") from e
    else:
        # constraint against an already-ingested template kind: no
        # alias needed, the candidate IS just a constraint
        if not kind:
            raise ScanFatal("candidate constraint has no kind")
        alias = kind
    c2 = copy.deepcopy(constraint)
    c2["kind"] = alias
    c2.setdefault("apiVersion", "constraints.gatekeeper.sh/v1beta1")
    c2.setdefault("metadata", {}).setdefault("name", "scan-preview")
    try:
        client.add_constraint(c2)
    except Exception as e:
        raise ScanFatal(f"candidate constraint rejected: {e}") from e
    return alias


def build_inproc_tier(policy_paths: list[str], aot_dir: str = "",
                      compile_cache_dir: str = "",
                      decision_cache: int = 4096,
                      timeout_s: float = 300.0,
                      preview_template: Optional[dict] = None,
                      preview_constraint: Optional[dict] = None,
                      client=None, device: str = "cuda") -> InprocTier:
    """The self-contained engine for cluster-free CI: a private client
    + MicroBatcher + ValidationHandler in this process. With --aot-dir
    the run populates (cold) or deserializes from (warm) the AOT
    store — the short-lived-invocation story."""
    if client is None:
        if compile_cache_dir:
            os.environ.setdefault("TRITON_CACHE_DIR", compile_cache_dir)
        from ..client import Backend
        from ..ir import TorchDriver
        from ..target import K8sValidationTarget

        # the card unless the caller asks for the CPU: TorchDriver
        # raises where none is visible
        driver = TorchDriver(device=device, aot_dir=aot_dir or None)
        client = Backend(driver).new_client([K8sValidationTarget()])
        if preview_constraint is not None:
            alias = ingest_candidate(client, preview_template,
                                     preview_constraint)
            log.info("scan preview candidate ingested",
                     details={"alias": alias})
        elif policy_paths:
            counts = ingest_policies(client, policy_paths)
            if not counts["templates"] and not counts["constraints"]:
                raise ScanFatal("no templates/constraints found under "
                                f"--policies {policy_paths}")
        else:
            raise ScanFatal("in-process scan needs --policies (or "
                            "--preview-constraint), or point at a "
                            "running engine with --backplane/--grpc")
    from .webhook import MicroBatcher, ValidationHandler

    batcher = MicroBatcher(client, max_wait=0.002, max_batch=256)
    validation = ValidationHandler(
        client, kube=None, batcher=batcher,
        decision_cache_size=decision_cache)
    return InprocTier(validation, timeout_s)


# ------------------------------------------------------------------- CLI


def _load_manifest_file(path: str) -> dict:
    docs = [d for s, d in
            ((s, p[1] if s == "ok" else p) for s, p in parse_file(path))
            if s == "ok"]
    if len(docs) != 1:
        raise ScanFatal(f"{path}: expected exactly one manifest "
                        f"(found {len(docs)})")
    return docs[0]


def build_scan_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gatekeeper-tpu scan",
        description="offline fleet scan: evaluate a repo tree / YAML "
                    "stream / JSONL inventory export against policy, "
                    "no cluster attached")
    p.add_argument("paths", nargs="+",
                   help="manifest sources: directories (repo trees), "
                        "multi-doc YAML files, or .jsonl inventory "
                        "exports")
    p.add_argument("--format", choices=("auto", "tree", "yaml",
                                        "jsonl"), default="auto",
                   help="source format (auto: directories walk as "
                        "trees, *.jsonl as JSONL, anything else as "
                        "multi-doc YAML)")
    p.add_argument("--policies", action="append", default=[],
                   help="template/constraint file or directory for the "
                        "in-process engine (repeatable)")
    p.add_argument("--backplane", default="",
                   help="scan through a running engine's backplane "
                        "socket (B-frame bulk ingest)")
    p.add_argument("--grpc", default="",
                   help="scan through a policy service address "
                        "(pipelined ReviewStream)")
    p.add_argument("--loaders", type=int,
                   default=min(4, os.cpu_count() or 1),
                   help="parallel loader processes (0 = parse inline)")
    p.add_argument("--batch", type=int, default=256,
                   help="manifests per bulk wire batch")
    p.add_argument("--depth", type=int, default=2,
                   help="bulk batches in flight (2 = double buffer)")
    p.add_argument("--dedupe", type=int, default=65536,
                   help="content-hash dedupe LRU size (0 disables)")
    p.add_argument("--decision-cache", type=int, default=4096,
                   help="in-process engine decision-cache size "
                        "(0 disables; cross-process tiers use the "
                        "serving engine's own)")
    p.add_argument("--aot-dir", default="",
                   help="AOT program store for the in-process engine "
                        "(cold run populates, warm run deserializes)")
    p.add_argument("--compile-cache-dir", default="",
                   help="persistent Triton kernel cache dir "
                        "(TRITON_CACHE_DIR, unless it is set already)")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="per-batch verdict deadline seconds (a cold "
                        "first batch may wait out one K2 compile)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the in-process engine: cuda "
                        "(the card, the default; raises where none is "
                        "visible) or cpu (the kernels' plain versions, "
                        "for tests). No fallback")
    p.add_argument("--output", default="-",
                   help="JSONL verdict records ('-' = stdout)")
    p.add_argument("--summary", default="",
                   help="also write the JSON summary to this file")
    p.add_argument("--preview-constraint", default="",
                   help="what-if mode: scan against ONLY this "
                        "candidate constraint (in-process tier)")
    p.add_argument("--preview-template", default="",
                   help="candidate ConstraintTemplate for "
                        "--preview-constraint (compiled under its "
                        "content-hashed alias kind)")
    p.add_argument("--log-level", default="WARNING")
    return p


def _resolve_sources(paths: list[str], fmt: str
                     ) -> tuple[str, list[str], int]:
    """(resolved format, loader path list, files skipped in walk)."""
    if fmt == "auto":
        if all(os.path.isdir(p) for p in paths):
            fmt = "tree"
        elif all(p.lower().endswith(".jsonl") for p in paths):
            fmt = "jsonl"
        elif any(os.path.isdir(p) for p in paths):
            fmt = "tree"
        else:
            fmt = "yaml"
    skipped_files = 0
    if fmt == "tree":
        files: list[str] = []
        for p in paths:
            if os.path.isdir(p):
                got, skipped = walk_tree(p)
                files.extend(got)
                skipped_files += skipped
            elif p.lower().endswith(MANIFEST_EXTS):
                files.append(p)
            else:
                skipped_files += 1
        return "tree", files, skipped_files
    for p in paths:
        if not os.path.exists(p):
            raise ScanFatal(f"source not found: {p}")
    return fmt, list(paths), 0


def scan_main(argv=None) -> int:
    from . import logging as glog

    args = build_scan_parser().parse_args(argv)
    glog.setup(args.log_level)
    try:
        fmt, src_paths, skipped_files = _resolve_sources(args.paths,
                                                         args.format)
        if not src_paths:
            raise ScanFatal("no manifest files found under "
                            f"{args.paths}")
        tiers_given = sum(1 for t in (args.backplane, args.grpc) if t)
        if tiers_given > 1:
            raise ScanFatal("--backplane and --grpc are exclusive")
        if args.preview_constraint and tiers_given:
            raise ScanFatal("--preview-constraint runs on the "
                            "in-process tier only (the candidate must "
                            "be compiled locally)")
        if args.backplane:
            tier = BackplaneTier(args.backplane, args.timeout)
        elif args.grpc:
            tier = GrpcTier(args.grpc, args.timeout)
        else:
            tier = build_inproc_tier(
                args.policies, aot_dir=args.aot_dir,
                compile_cache_dir=args.compile_cache_dir,
                decision_cache=args.decision_cache, device=args.device,
                timeout_s=args.timeout,
                preview_template=(
                    _load_manifest_file(args.preview_template)
                    if args.preview_template else None),
                preview_constraint=(
                    _load_manifest_file(args.preview_constraint)
                    if args.preview_constraint else None))
    except ScanFatal as e:
        print(json.dumps({"error": str(e)}), file=sys.stderr)
        return 3
    loader = LoaderPool(fmt, src_paths, args.loaders,
                        encode=tier.wants_bytes)
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        summary = run_scan(tier, loader, out,
                           batch_size=max(1, args.batch),
                           depth=max(1, args.depth),
                           dedupe_size=args.dedupe)
    finally:
        tier.close()
        if out is not sys.stdout:
            out.close()
    summary["format"] = fmt
    summary["skipped_files"] = skipped_files
    if args.preview_constraint:
        summary["preview"] = True
    if args.summary:
        with open(args.summary, "w") as f:
            json.dump(summary, f)
    rate = summary["manifests_per_sec"]
    print(f"fleet scan: {summary['manifests']} manifests "
          f"({summary['unique_evaluated']} unique evaluated, "
          f"{summary['deduped']} deduped) in {summary['wall_s']}s "
          f"[{rate}/s] via {summary['tier']} — "
          f"{summary['denied']} denied, {summary['errors']} errors, "
          f"{summary['skipped_docs']} non-k8s docs skipped",
          file=sys.stderr)
    print(json.dumps(summary), file=sys.stderr)
    return exit_code(summary)
