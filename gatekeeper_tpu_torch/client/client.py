"""The constraint-framework Client: orchestration core of the framework.

Behavior parity with the reference Client
(vendor/.../constraint/pkg/client/client.go): template/constraint CRUD with
semantic-equal dedupe, data CRUD routed through target handlers,
Review/Audit queries through the Driver seam, CRD generation/validation,
and Reset. Targets and templates are cached so constraints can be validated
without the driver.

Differences by design (TPU-first):
  * modules are parsed+rewritten ASTs, not source strings — template
    ingestion does not recompile unrelated modules (the reference's
    local driver recompiles the world per change, local.go:168-207);
  * driver data paths are tuples, so no URL escaping / path joining.
"""

from __future__ import annotations

import copy
import json
import threading
from typing import Any, Iterable, Optional, Union

from .crd import CRDError, create_crd, create_schema, validate_cr, validate_crd
from .drivers import Driver, hook_audit_path, hook_violation_path
from .rewriter import RewriteError, rewrite_template_modules
from .templates import (
    CONSTRAINT_GROUP,
    ConstraintTemplate,
    TemplateError,
    load_template,
)
from .types import (
    ClientError,
    ErrorMap,
    MissingTemplateError,
    Response,
    Responses,
    UnrecognizedConstraintError,
)


class Backend:
    """Driver holder + client factory (reference backend.go:28-49: one
    client per backend)."""

    def __init__(self, driver: Driver):
        self.driver = driver
        self._has_client = False

    def new_client(self, targets: Iterable[Any],
                   allowed_data_fields: tuple = ("inventory",)) -> "Client":
        if self._has_client:
            raise ClientError("backend already has a client")
        self._has_client = True
        client = Client(self.driver, targets, allowed_data_fields)
        client.init()
        return client


class _TemplateEntry:
    def __init__(self, template: ConstraintTemplate, crd: dict, targets: list[str]):
        self.template = template
        self.crd = crd
        self.targets = targets
        self.constraints: dict[str, dict] = {}  # name -> unstructured


class Client:
    def __init__(self, driver: Driver, targets: Iterable[Any],
                 allowed_data_fields: tuple = ("inventory",)):
        self.driver = driver
        self.targets = {t.get_name(): t for t in targets}
        if not self.targets:
            raise ClientError("client must have at least one target")
        self.allowed_data_fields = allowed_data_fields
        self._lock = threading.RLock()
        self._templates: dict[str, _TemplateEntry] = {}  # by Kind
        # library generation: bumped whenever anything a review's verdict
        # can depend on changes (templates, constraints, synced data).
        # The admission decision cache keys on it, so a template or
        # constraint update invalidates every cached decision at once
        # without an explicit flush. Semantic-equal dedupes do NOT bump —
        # a level-triggered controller replaying identical CRs must not
        # cold the cache.
        self._generation = 0
        # library-change observer (the N-engine admission plane's
        # replication hook): called AFTER a mutation applied and bumped
        # this client's generation, with (op, plain object) — ops:
        # add_template / remove_template / add_constraint /
        # remove_constraint / add_data / remove_data. Semantic-equal
        # dedupes do not notify (nothing changed, nothing to fan out).
        # Each replica client bumps ITS OWN generation when the op
        # lands there, so every engine's decision-cache keys stay
        # coherent with that engine's library.
        self.on_change: Optional[Any] = None

    def _notify(self, op: str, obj) -> None:
        """Run the observer OUTSIDE the client lock (it does I/O to the
        engine processes); a replication failure is the supervisor's to
        heal (resync), never an ingestion error."""
        cb = self.on_change
        if cb is None or obj is None:
            return
        try:
            cb(op, obj)
        except Exception:
            import logging

            logging.getLogger("gatekeeper_tpu_torch.client").warning(
                "library change notification failed", exc_info=True)

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def _bump_generation(self) -> None:
        with self._lock:
            self._generation += 1

    def init(self) -> None:
        self.driver.init()

    # ------------------------------------------------------------ templates

    def _load(self, templ: Union[dict, ConstraintTemplate]) -> ConstraintTemplate:
        if isinstance(templ, ConstraintTemplate):
            return templ
        try:
            return load_template(templ)
        except TemplateError as e:
            raise ClientError(str(e)) from None

    def _artifacts(self, ct: ConstraintTemplate):
        if len(ct.targets) != 1:
            raise ClientError(
                f"expected exactly 1 item in targets, got {len(ct.targets)}"
            )
        tspec = ct.targets[0]
        handler = self.targets.get(tspec.target)
        if handler is None:
            raise ClientError(f"target {tspec.target} is not recognized")
        schema = create_schema(ct, handler.match_schema())
        crd = create_crd(ct, schema)
        try:
            validate_crd(crd)
        except CRDError as e:
            raise ClientError(f"invalid CRD for template {ct.name}: {e}") from None
        try:
            modules = rewrite_template_modules(
                tspec.target, ct.kind, tspec.rego, tspec.libs,
                allowed_externs=self.allowed_data_fields,
                source_name=f"template:{ct.name}",
            )
        except RewriteError as e:
            raise ClientError(str(e)) from None
        return handler, crd, modules

    def create_crd(self, templ: Union[dict, ConstraintTemplate]) -> dict:
        ct = self._load(templ)
        _, crd, _ = self._artifacts(ct)
        return crd

    def add_template(self, templ: Union[dict, ConstraintTemplate]) -> Responses:
        ct = self._load(templ)
        resp = Responses()
        with self._lock:
            cached = self._templates.get(ct.kind)
            if cached is not None and cached.template.semantic_equal(ct):
                for t in cached.targets:
                    resp.handled[t] = True
                return resp
            handler, crd, modules = self._artifacts(ct)
            if cached is not None:
                # a template may switch targets; scrub the old target's
                # modules and constraint data so it stops enforcing
                for old_target in cached.targets:
                    if old_target != handler.get_name():
                        self.driver.delete_modules(
                            self._module_prefix(old_target, ct.kind))
                        self.driver.delete_data(
                            ("constraints", old_target, "cluster",
                             CONSTRAINT_GROUP, ct.kind))
            prefix = self._module_prefix(handler.get_name(), ct.kind)
            self.driver.put_modules(prefix, modules)
            entry = _TemplateEntry(ct, crd, [handler.get_name()])
            if cached is not None:
                entry.constraints = cached.constraints
            self._templates[ct.kind] = entry
            resp.handled[handler.get_name()] = True
            self._generation += 1
        self._notify("add_template",
                     templ if isinstance(templ, dict) else ct.raw)
        return resp

    def remove_template(self, templ: Union[dict, ConstraintTemplate]) -> Responses:
        ct = self._load(templ)
        resp = Responses()
        with self._lock:
            entry = self._templates.pop(ct.kind, None)
            if entry is None:
                return resp
            for target in entry.targets:
                self.driver.delete_modules(self._module_prefix(target, ct.kind))
                # drop the template's constraint instances from the store
                self.driver.delete_data(
                    ("constraints", target, "cluster", CONSTRAINT_GROUP, ct.kind)
                )
                resp.handled[target] = True
            self._generation += 1
        self._notify("remove_template",
                     templ if isinstance(templ, dict) else ct.raw)
        return resp

    def get_template(self, kind_or_templ: Union[str, dict, ConstraintTemplate]
                     ) -> ConstraintTemplate:
        kind = kind_or_templ if isinstance(kind_or_templ, str) else \
            self._load(kind_or_templ).kind
        with self._lock:
            entry = self._templates.get(kind)
            if entry is None:
                raise MissingTemplateError(f"template for kind {kind} not found")
            return copy.deepcopy(entry.template)

    def _module_prefix(self, target: str, kind: str) -> str:
        return f'templates["{target}"]["{kind}"]'

    # ----------------------------------------------------------- constraints

    def _entry_for_constraint(self, constraint: dict) -> _TemplateEntry:
        kind = constraint.get("kind") or ""
        if not kind:
            raise ClientError(
                f"Constraint {(constraint.get('metadata') or {}).get('name')} "
                "has no kind"
            )
        group = (constraint.get("apiVersion") or "").partition("/")[0]
        if group != CONSTRAINT_GROUP:
            raise ClientError(
                f"Constraint {(constraint.get('metadata') or {}).get('name')} "
                "has the wrong group"
            )
        entry = self._templates.get(kind)
        if entry is None:
            raise UnrecognizedConstraintError(kind)
        return entry

    def _constraint_path(self, target: str, constraint: dict) -> tuple:
        name = (constraint.get("metadata") or {}).get("name") or ""
        if not name:
            raise ClientError("constraint has no name")
        return ("constraints", target, "cluster", CONSTRAINT_GROUP,
                constraint["kind"], name)

    def add_constraint(self, constraint: dict) -> Responses:
        resp = Responses()
        errs = ErrorMap()
        with self._lock:
            entry = self._entry_for_constraint(constraint)
            name = (constraint.get("metadata") or {}).get("name") or ""
            cached = entry.constraints.get(name)
            if cached is not None and _constraint_semantic_equal(cached, constraint):
                for t in entry.targets:
                    resp.handled[t] = True
                return resp
            self._validate_constraint_locked(constraint, entry)
            for target in entry.targets:
                try:
                    self.driver.put_data(
                        self._constraint_path(target, constraint), constraint
                    )
                    resp.handled[target] = True
                except Exception as e:  # driver errors surface per target
                    errs[target] = e
            if not errs:
                entry.constraints[name] = copy.deepcopy(constraint)
                self._generation += 1
        if errs:
            raise ClientError(str(errs))
        self._notify("add_constraint", constraint)
        return resp

    def remove_constraint(self, constraint: dict) -> Responses:
        resp = Responses()
        with self._lock:
            entry = self._entry_for_constraint(constraint)
            name = (constraint.get("metadata") or {}).get("name") or ""
            for target in entry.targets:
                self.driver.delete_data(self._constraint_path(target, constraint))
                resp.handled[target] = True
            entry.constraints.pop(name, None)
            self._generation += 1
        self._notify("remove_constraint", constraint)
        return resp

    def get_constraint(self, kind: str, name: str) -> dict:
        with self._lock:
            entry = self._templates.get(kind)
            if entry is None:
                raise UnrecognizedConstraintError(kind)
            c = entry.constraints.get(name)
            if c is None:
                raise ClientError(f"constraint {kind}/{name} not found")
            return copy.deepcopy(c)

    def validate_constraint(self, constraint: dict) -> None:
        """Validate without mutating state (webhook path, client.go:655-659)."""
        with self._lock:
            entry = self._entry_for_constraint(constraint)
            self._validate_constraint_locked(constraint, entry)

    def _validate_constraint_locked(self, constraint: dict,
                                    entry: _TemplateEntry) -> None:
        try:
            validate_cr(constraint, entry.crd)
        except CRDError as e:
            raise ClientError(str(e)) from None
        for target in entry.targets:
            self.targets[target].validate_constraint(constraint)

    # ----------------------------------------------------------------- data

    def add_data(self, obj: Any) -> Responses:
        resp = Responses()
        errs = ErrorMap()
        for name, handler in self.targets.items():
            try:
                handled, path, data = handler.process_data(obj)
            except Exception as e:
                errs[name] = e
                continue
            if not handled:
                continue
            try:
                self.driver.put_data(("external", name) + tuple(path), data)
                resp.handled[name] = True
            except Exception as e:
                errs[name] = e
        if resp.handled:
            # synced inventory feeds referential policies: a data change
            # can flip a cached verdict, so it invalidates like a
            # constraint change (clusters without sync never pay this)
            self._bump_generation()
            self._notify("add_data", obj)
        if errs:
            raise ClientError(str(errs))
        return resp

    def remove_data(self, obj: Any) -> Responses:
        resp = Responses()
        errs = ErrorMap()
        for name, handler in self.targets.items():
            try:
                handled, path, _ = handler.process_data(obj)
            except Exception as e:
                errs[name] = e
                continue
            if not handled:
                continue
            try:
                self.driver.delete_data(("external", name) + tuple(path))
                resp.handled[name] = True
            except Exception as e:
                errs[name] = e
        if resp.handled:
            self._bump_generation()
            self._notify("remove_data", obj)
        if errs:
            raise ClientError(str(errs))
        return resp

    # -------------------------------------------------------------- queries

    def review(self, obj: Any, tracing: bool = False) -> Responses:
        with self._lock:
            return self._review_locked(obj, tracing)

    def _review_locked(self, obj: Any, tracing: bool) -> Responses:
        responses = Responses()
        errs = ErrorMap()
        for name, handler in self.targets.items():
            try:
                handled, review = handler.handle_review(obj)
            except Exception as e:
                errs[name] = e
                continue
            if not handled:
                continue
            try:
                resp = self.driver.query(
                    hook_violation_path(name), {"review": review},
                    tracing=tracing,
                )
                memo: dict = {}
                for r in resp.results:
                    handler.handle_violation(r, memo)
            except Exception as e:
                errs[name] = e
                continue
            resp.target = name
            responses.by_target[name] = resp
        if errs:
            raise ClientError(str(errs))
        return responses

    def review_batch(self, objs: list, tracing: bool = False
                     ) -> list[Responses]:
        """Batched Review: per-object semantics identical to review(),
        with the driver's vectorized review_batch amortizing evaluation
        across the whole batch when available (the gRPC ReviewBatch RPC
        and any bulk caller land here). Tracing and drivers without a
        batch entry point fall back to per-object review."""
        driver_batch = getattr(self.driver, "review_batch", None)
        with self._lock:
            if tracing or driver_batch is None:
                return [self._review_locked(o, tracing) for o in objs]
            out = [Responses() for _ in objs]
            for name, handler in self.targets.items():
                reviews: list = []
                idxs: list[int] = []
                errs = ErrorMap()
                for i, obj in enumerate(objs):
                    try:
                        handled, review = handler.handle_review(obj)
                    except Exception as e:
                        # keyed per batch index: several bad objects in
                        # one batch must all be reported, with positions
                        errs[f"{name}[{i}]"] = e
                        continue
                    if handled:
                        reviews.append(review)
                        idxs.append(i)
                if errs:
                    # same contract as review(): an unhandleable object
                    # fails the call (the wire envelope carries it)
                    raise ClientError(str(errs))
                try:
                    batches = driver_batch(name, reviews)
                    for i, results in zip(idxs, batches):
                        memo: dict = {}
                        for r in results:
                            handler.handle_violation(r, memo)
                        resp = Response(results=results)
                        resp.target = name
                        out[i].by_target[name] = resp
                except Exception as e:
                    # same envelope as review(): evaluation AND
                    # violation-handling failures surface as ClientError
                    raise ClientError(str(ErrorMap({name: e}))) from e
            return out

    def audit(self, tracing: bool = False) -> Responses:
        with self._lock:
            return self._audit_locked(tracing)

    def _audit_locked(self, tracing: bool) -> Responses:
        responses = Responses()
        errs = ErrorMap()
        for name, handler in self.targets.items():
            try:
                resp = self.driver.query(hook_audit_path(name), None,
                                         tracing=tracing)
                memo: dict = {}
                for r in resp.results:
                    handler.handle_violation(r, memo)
            except Exception as e:
                errs[name] = e
                continue
            resp.target = name
            responses.by_target[name] = resp
        if errs:
            raise ClientError(str(errs))
        return responses

    # ----------------------------------------------------------------- misc

    def reset(self) -> None:
        """Wipe all state (reference client.go:726-747)."""
        with self._lock:
            for name in self.targets:
                self.driver.delete_data(("external", name))
                self.driver.delete_data(("constraints", name))
            for kind, entry in self._templates.items():
                for target in entry.targets:
                    self.driver.delete_modules(self._module_prefix(target, kind))
            self._templates = {}
            self._generation += 1

    def snapshot_library(self) -> dict:
        """Raw SOURCES of every ingested template and constraint, for
        the warm-restart state snapshot (control/statestore.py). Restore
        replays them through add_template/add_constraint — the normal
        ingestion path, so compile metadata and validation run exactly
        as they would from a watch delivery — before the controllers'
        level-triggered replay arrives and dedupes via semantic-equal."""
        with self._lock:
            templates = []
            constraints = []
            for kind in sorted(self._templates):
                entry = self._templates[kind]
                if entry.template.raw is not None:
                    templates.append(copy.deepcopy(entry.template.raw))
                for name in sorted(entry.constraints):
                    constraints.append(
                        copy.deepcopy(entry.constraints[name]))
        return {"templates": templates, "constraints": constraints}

    def restore_library(self, snap: dict) -> dict:
        """Re-ingest a snapshot_library() payload. Per-item failures are
        collected, not raised: one stale template must not abort the
        whole warm boot (its live CR re-ingests via the watch replay)."""
        ok = errors = 0
        for t in snap.get("templates") or []:
            try:
                self.add_template(t)
                ok += 1
            except ClientError:
                errors += 1
        for c in snap.get("constraints") or []:
            try:
                self.add_constraint(c)
                ok += 1
            except ClientError:
                errors += 1
        return {"restored": ok, "errors": errors}

    def dump(self) -> str:
        return self.driver.dump()

    def knows_kind(self, kind: str) -> bool:
        with self._lock:
            return kind in self._templates

    def library_index(self) -> dict:
        """{kind: [constraint names]} of the ingested library — the
        N-engine sync diff uses it to drop templates/constraints a
        restarted primary no longer carries."""
        with self._lock:
            return {k: sorted(e.constraints)
                    for k, e in self._templates.items()}

    def template_kinds(self) -> list[str]:
        with self._lock:
            return sorted(self._templates)


def _constraint_semantic_equal(a: dict, b: dict) -> bool:
    """Spec+meta equality ignoring status (reference
    util/constraint SemanticEqual used at client.go:556)."""
    def key(c: dict):
        meta = c.get("metadata") or {}
        return json.dumps(
            {
                "apiVersion": c.get("apiVersion"),
                "kind": c.get("kind"),
                "name": meta.get("name"),
                "labels": meta.get("labels"),
                "annotations": meta.get("annotations"),
                "spec": c.get("spec"),
            },
            sort_keys=True,
        )
    return key(a) == key(b)
