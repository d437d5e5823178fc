"""What-if preview: evaluate a candidate ConstraintTemplate/Constraint
against the full cached inventory BEFORE it is enforced.

The TPU-only capability the streaming-audit tentpole unlocks: the
inventory is already resident as encoded feature tensors, so sweeping a
candidate policy over 100k+ objects is one device dispatch — an
interpreter line would pay per-object evaluation and could never answer
interactively. `POST /v1/preview` (and `gatekeeper-tpu preview`) takes a
constraint — plus, optionally, a not-yet-installed template — and
returns violation counts and capped samples, without touching the
serving library.

Isolation: the candidate template is compiled under a CONTENT-HASHED
ALIAS KIND (`<Kind>PV<sha12>`), so every per-kind structure it rides —
interpreter package, device program, match mask, extracted feature rows,
AOT store entries — is namespaced away from the serving library's. No
client generation bump, no decision-cache invalidation, no param-cache
clobber. Repeat previews of the same template content hit the alias's
warm caches (sub-second over 100k objects); inventory churn in between
is absorbed by the same patch journal the incremental audit uses.

Off-path compilation: alias ingestion rides the driver's normal
ingest-time prewarm (AOT deserialize on a background thread) and the
sweep rides the async-warm gate, so a cold preview's XLA compile runs
under the driver's warm semaphore off the serving path — admission and
audit sweeps never block on a preview's COMPILER time. The preview CALL
itself may wait out its own compile; that is the request's cost, not
the plane's. The sweep proper does hold the client evaluation lock
(the same discipline as a full audit sweep), so on a pod that also
serves admission a preview delays concurrent verdicts by the warm
sweep's duration; previews serialize on their own lock so at most one
sweep is ever on that lock, and latency-sensitive deployments point
previews at the audit pod's dedicated --preview-port instead.
"""

from __future__ import annotations

import copy
import hashlib
import json
import threading
import time
from collections import OrderedDict
from typing import Optional

from ..client.crd import CRDError, create_crd, create_schema, validate_cr
from ..client.rewriter import RewriteError, rewrite_template_modules
from ..client.templates import TemplateError, load_template
from ..client.types import ClientError, MissingTemplateError
from . import jsonio, metrics
from .logging import logger
from .util import DEFAULT_ENFORCEMENT_ACTION, VALID_ENFORCEMENT_ACTIONS

log = logger("preview")

MSG_SIZE_LIMIT = 256  # sample message truncation (audit parity)
DEFAULT_SAMPLE_LIMIT = 20
MAX_SAMPLE_LIMIT = 500


class PreviewError(Exception):
    """Caller error (bad payload, unknown template, invalid
    constraint): answered as HTTP 400, never a 500."""


class PreviewEngine:
    """Transport-independent preview evaluation over a Client.

    Compiled candidates are LRU-cached by template-content hash
    (MAX_COMPILED entries); eviction deletes the alias's modules, which
    drops every per-kind cache the driver held for it."""

    MAX_COMPILED = 8

    def __init__(self, opa, target: Optional[str] = None):
        self.opa = opa
        self.target = target or next(iter(opa.targets))
        self._lock = threading.Lock()
        # previews serialize end-to-end on this lock (compile, LRU
        # eviction, sweep): eviction can therefore never delete the
        # modules of an entry another in-flight preview is still
        # sweeping, and at most ONE preview sweep at a time ever queues
        # on the client evaluation lock admission shares
        self._eval_lock = threading.Lock()
        # content sha -> {"alias", "kind", "crd", "prefix", "handler"}
        self._compiled: "OrderedDict[str, dict]" = OrderedDict()

    # ------------------------------------------------------- compilation

    def _ensure_template(self, template_raw: Optional[dict],
                         kind: str) -> tuple[dict, bool]:
        """Compile the candidate template (or the ingested one for
        `kind`) under its content-hashed alias. Returns (entry, cold)."""
        if template_raw is not None:
            try:
                ct = load_template(template_raw)
            except TemplateError as e:
                raise PreviewError(f"invalid template: {e}") from None
        else:
            try:
                ct = self.opa.get_template(kind)
            except (MissingTemplateError, ClientError):
                raise PreviewError(
                    f"no ingested template for kind {kind!r}; include "
                    "the candidate template in the request") from None
        raw = ct.raw if isinstance(ct.raw, dict) else {}
        content = raw.get("spec") or [
            ct.name, ct.kind, ct.validation_schema,
            [(t.target, t.rego, t.libs) for t in ct.targets]]
        sha = hashlib.sha256(json.dumps(
            content, sort_keys=True,
            default=str).encode()).hexdigest()[:12]
        with self._lock:
            ent = self._compiled.get(sha)
            if ent is not None:
                self._compiled.move_to_end(sha)
                return ent, False
            if len(ct.targets) != 1:
                raise PreviewError("template must have exactly 1 target")
            tspec = ct.targets[0]
            handler = self.opa.targets.get(tspec.target)
            if handler is None:
                raise PreviewError(
                    f"target {tspec.target!r} is not recognized")
            alias = f"{ct.kind}PV{sha}"
            try:
                crd = create_crd(ct, create_schema(
                    ct, handler.match_schema()))
                modules = rewrite_template_modules(
                    tspec.target, alias, tspec.rego, tspec.libs,
                    allowed_externs=self.opa.allowed_data_fields,
                    source_name=f"preview:{ct.name}")
            except (CRDError, RewriteError) as e:
                raise PreviewError(f"template does not compile: {e}") \
                    from None
            prefix = f'templates["{tspec.target}"]["{alias}"]'
            # under the client lock: module installation must not race a
            # library ingestion touching the driver's shared tables
            with self.opa._lock:
                self.opa.driver.put_modules(prefix, modules)
            ent = {"alias": alias, "kind": ct.kind, "crd": crd,
                   "prefix": prefix, "handler": handler,
                   "target": tspec.target}
            self._compiled[sha] = ent
            while len(self._compiled) > self.MAX_COMPILED:
                _, old = self._compiled.popitem(last=False)
                with self.opa._lock:
                    try:
                        self.opa.driver.delete_modules(old["prefix"])
                    except Exception:
                        pass  # eviction is best-effort cleanup
            log.info("preview template compiled",
                     details={"kind": ct.kind, "alias": alias})
        return ent, True

    # -------------------------------------------------------- evaluation

    def preview(self, payload: dict) -> dict:
        """Evaluate one candidate. Payload:
          {"constraint": {...},            # required
           "template": {...},              # optional (else: ingested)
           "limit": 20}                    # sample cap
        """
        t0 = time.monotonic()
        constraint = payload.get("constraint")
        if not isinstance(constraint, dict):
            raise PreviewError('payload needs a "constraint" object')
        template = payload.get("template")
        if template is not None and not isinstance(template, dict):
            raise PreviewError('"template" must be an object when given')
        try:
            limit = int(payload.get("limit", DEFAULT_SAMPLE_LIMIT))
        except (TypeError, ValueError):
            raise PreviewError('"limit" must be an integer') from None
        limit = min(max(limit, 0), MAX_SAMPLE_LIMIT)
        kind = constraint.get("kind") or ""
        if template is not None:
            tkind = ((template.get("spec") or {}).get("crd") or {}) \
                .get("spec", {}).get("names", {}).get("kind") or kind
            kind = kind or tkind
            if kind and tkind and kind != tkind:
                raise PreviewError(
                    f"constraint kind {kind!r} does not match the "
                    f"template's CRD kind {tkind!r}")
        if not kind:
            raise PreviewError("constraint has no kind")
        spec = constraint.get("spec")
        spec = spec if isinstance(spec, dict) else {}
        action = spec.get("enforcementAction") or DEFAULT_ENFORCEMENT_ACTION
        if action not in VALID_ENFORCEMENT_ACTIONS:
            raise PreviewError(
                f"invalid enforcementAction {action!r}; must be one of "
                f"{VALID_ENFORCEMENT_ACTIONS}")
        with self._eval_lock:
            ent, cold = self._ensure_template(template, kind)
            # validate the candidate against the template's CRD + match
            # schema exactly as ingestion would (kind/apiVersion
            # defaulted: a preview payload is allowed to be minimal)
            con = copy.deepcopy(constraint)
            con.setdefault("kind", kind)
            con.setdefault("apiVersion",
                           "constraints.gatekeeper.sh/v1beta1")
            (con.setdefault("metadata", {})).setdefault("name", "preview")
            try:
                validate_cr(con, ent["crd"])
                ent["handler"].validate_constraint(con)
            except (CRDError, ClientError, ValueError) as e:
                raise PreviewError(f"invalid constraint: {e}") from None
            alias_con = copy.deepcopy(con)
            alias_con["kind"] = ent["alias"]
            driver = self.opa.driver
            # the sweep holds the client evaluation lock — the same
            # discipline as a full audit sweep (Client.audit), so an
            # admission review on a colocated webhook pod queues
            # behind it for the warm sweep's duration (compile time
            # is already off this path via the warm gate)
            with self.opa._lock:
                n_reviews = len(driver._inventory_reviews(self.target))
                if hasattr(driver, "audit_kind"):
                    results, path = driver.audit_kind(
                        self.target, ent["alias"], [alias_con])
                else:
                    results = self._interp_eval(ent["alias"], [alias_con])
                    path = "interp"
        dt = time.monotonic() - t0
        metrics.report_preview("ok", dt)
        out = {
            "kind": kind,
            "constraint": (con.get("metadata") or {}).get("name"),
            "enforcementAction": action,
            "violations": len(results),
            "reviewed": n_reviews,
            "path": path,
            "cold": cold,
            "duration_s": round(dt, 4),
            "samples": self._samples(results, action, limit),
        }
        log.info("what-if preview evaluated",
                 details={k: out[k] for k in
                          ("kind", "violations", "reviewed", "path",
                           "cold", "duration_s")})
        return out

    def _interp_eval(self, alias: str, cons: list) -> list:
        """Pure-interpreter sweep (drivers without audit_kind; also the
        differential oracle the preview tests compare against)."""
        import numpy as np

        from ..target.batch import match_masks

        d = self.opa.driver
        reviews = d._inventory_reviews(self.target)
        lookup_ns = d._namespace_lookup(self.target)
        inventory = d._inventory_tree(self.target)
        mask = match_masks(cons, reviews, lookup_ns)
        out = []
        for r_idx, c_idx in zip(*np.nonzero(mask)):
            constraint = cons[int(c_idx)]
            spec = constraint.get("spec")
            spec = spec if isinstance(spec, dict) else {}
            out.extend(d._eval_template_violations(
                self.target, constraint, reviews[int(r_idx)],
                spec.get("enforcementAction") or "deny", inventory,
                None))
        return out

    @staticmethod
    def _samples(results: list, action: str, limit: int) -> list:
        entries = []
        for r in results[:limit]:
            # interpreter-path results carry the object on the review
            # (resource stays None there); prefer resource when set
            review = getattr(r, "review", None) or {}
            res = r.resource or review.get("object") or {}
            meta = res.get("metadata") or {}
            msg = r.msg
            if len(msg.encode()) > MSG_SIZE_LIMIT:
                msg = msg.encode()[:MSG_SIZE_LIMIT].decode("utf-8",
                                                           "ignore")
            entry = {"message": msg, "enforcementAction": action,
                     "kind": (res.get("kind")
                              or (review.get("kind") or {}).get("kind")),
                     "name": meta.get("name") or review.get("name"),
                     "namespace": (meta.get("namespace")
                                   or review.get("namespace"))}
            entries.append({k: v for k, v in entry.items()
                            if v is not None})
        return entries

    # --------------------------------------------------------- transport

    def handle_http(self, body: bytes) -> tuple[int, bytes]:
        """(status, json payload) for the /v1/preview endpoint."""
        try:
            payload = jsonio.loads(body)
        except ValueError:
            metrics.report_preview("invalid", 0.0)
            return 400, b'{"error": "request body is not valid JSON"}'
        if not isinstance(payload, dict):
            metrics.report_preview("invalid", 0.0)
            return 400, b'{"error": "request body must be an object"}'
        try:
            out = self.preview(payload)
        except PreviewError as e:
            metrics.report_preview("invalid", 0.0)
            return 400, jsonio.dumps_bytes({"error": str(e)})
        except Exception as e:
            # ALL infrastructure-failure classes count here — compile
            # (put_modules), validation surprises, driver eval — so the
            # outcome="error" counter matches the 500s callers see
            metrics.report_preview("error", 0.0)
            log.error("preview evaluation failed", details=str(e))
            return 500, jsonio.dumps_bytes({"error": str(e)})
        return 200, jsonio.dumps_bytes(out)
