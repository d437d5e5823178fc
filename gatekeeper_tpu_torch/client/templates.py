"""ConstraintTemplate model.

The reference defines versioned CRD Go types (v1alpha1/v1beta1) converted to
an unversioned internal form (vendor/.../constraint/pkg/apis/templates/
core/templates/constrainttemplate_types.go:31-113). Here templates are
ingested from unstructured dicts (as parsed from YAML) in any of those
versions — the conversion is shape-preserving, so a single loader suffices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

TEMPLATE_GROUP = "templates.gatekeeper.sh"
TEMPLATE_VERSIONS = ("v1beta1", "v1alpha1")
CONSTRAINT_GROUP = "constraints.gatekeeper.sh"


class TemplateError(Exception):
    pass


@dataclass
class TemplateTarget:
    target: str
    rego: str
    libs: list[str] = field(default_factory=list)


@dataclass
class ConstraintTemplate:
    name: str
    kind: str  # CRD names.kind for generated constraints, e.g. K8sRequiredLabels
    targets: list[TemplateTarget]
    # openAPIV3Schema for spec.parameters (plain dict), may be None
    validation_schema: Optional[dict] = None
    api_version: str = f"{TEMPLATE_GROUP}/v1beta1"
    metadata: dict = field(default_factory=dict)
    raw: Optional[dict] = None

    def semantic_equal(self, other: "ConstraintTemplate") -> bool:
        """Spec-level equality used for no-op dedupe on AddTemplate
        (reference client.go:370-373 SemanticEqual)."""
        return (
            self.name == other.name
            and self.kind == other.kind
            and self.validation_schema == other.validation_schema
            and [(t.target, t.rego, t.libs) for t in self.targets]
            == [(t.target, t.rego, t.libs) for t in other.targets]
        )


def load_template(obj: dict) -> ConstraintTemplate:
    """Parse an unstructured ConstraintTemplate (any supported version)."""
    if not isinstance(obj, dict):
        raise TemplateError("template must be an object")
    api_version = obj.get("apiVersion", f"{TEMPLATE_GROUP}/v1beta1")
    group = api_version.split("/")[0] if "/" in api_version else ""
    if group != TEMPLATE_GROUP:
        raise TemplateError(f"unexpected template group {group!r}")
    if obj.get("kind") not in (None, "ConstraintTemplate"):
        raise TemplateError(f"unexpected kind {obj.get('kind')!r}")
    metadata = obj.get("metadata") or {}
    name = metadata.get("name") or ""
    spec = obj.get("spec") or {}

    crd_spec = ((spec.get("crd") or {}).get("spec")) or {}
    names = crd_spec.get("names") or {}
    kind = names.get("kind") or ""
    if not kind:
        raise TemplateError(f"template {name!r}: missing spec.crd.spec.names.kind")
    # The reference requires metadata.name == lowercase(kind)
    # (crd_helpers.go validateTargets path; e2e "Bad Name" case).
    if name != kind.lower():
        raise TemplateError(
            f"template name {name!r} must equal lowercase of kind {kind!r}"
        )

    validation = crd_spec.get("validation") or {}
    schema = validation.get("openAPIV3Schema")

    targets_spec = spec.get("targets")
    if not targets_spec or not isinstance(targets_spec, list):
        raise TemplateError(f"template {name!r}: no targets specified")
    targets = []
    for t in targets_spec:
        tname = t.get("target") or ""
        rego = t.get("rego") or ""
        if not tname:
            raise TemplateError(f"template {name!r}: target missing name")
        if not rego:
            raise TemplateError(f"template {name!r}: target {tname} has no rego")
        targets.append(
            TemplateTarget(target=tname, rego=rego, libs=list(t.get("libs") or []))
        )

    return ConstraintTemplate(
        name=name,
        kind=kind,
        targets=targets,
        validation_schema=schema,
        api_version=api_version,
        metadata=dict(metadata),
        raw=obj,
    )
