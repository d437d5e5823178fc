"""Constraint-CRD generation and custom-resource validation.

Behavior parity with the reference crd helper
(vendor/.../constraint/pkg/client/crd_helpers.go): the per-template
constraint CRD's schema is `{spec: {match: <target MatchSchema>,
parameters: <template openAPIV3Schema>, enforcementAction: string}}`;
constraints are validated against that schema plus name/kind/group/version
checks. CRDs here are plain dicts (apiextensions v1beta1 shape) — there is
no client-go scheme machinery to mirror.
"""

from __future__ import annotations

import re
from typing import Any

from .templates import CONSTRAINT_GROUP, ConstraintTemplate

SUPPORTED_CONSTRAINT_VERSIONS = ("v1alpha1", "v1beta1")

_DNS1123_RE = re.compile(
    r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?(\.[a-z0-9]([-a-z0-9]*[a-z0-9])?)*$"
)


class CRDError(Exception):
    pass


def create_schema(templ: ConstraintTemplate, match_schema: dict) -> dict:
    props: dict[str, Any] = {
        "match": match_schema,
        "enforcementAction": {"type": "string"},
    }
    if templ.validation_schema is not None:
        props["parameters"] = templ.validation_schema
    return {"properties": {"spec": {"properties": props}}}


def create_crd(templ: ConstraintTemplate, schema: dict) -> dict:
    kind = templ.kind
    plural = kind.lower()
    return {
        "apiVersion": "apiextensions.k8s.io/v1beta1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{plural}.{CONSTRAINT_GROUP}"},
        "spec": {
            "group": CONSTRAINT_GROUP,
            "names": {
                "kind": kind,
                "listKind": kind + "List",
                "plural": plural,
                "singular": plural,
                "categories": ["constraint"],
            },
            "scope": "Cluster",
            "version": "v1beta1",
            "subresources": {"status": {}},
            "versions": [
                {"name": "v1beta1", "storage": True, "served": True},
                {"name": "v1alpha1", "storage": False, "served": True},
            ],
            "validation": {"openAPIV3Schema": schema},
        },
    }


def validate_crd(crd: dict) -> None:
    """Structural sanity of a generated CRD (stand-in for the apiextensions
    validation pass the reference runs; createTemplateArtifacts path)."""
    spec = crd.get("spec") or {}
    names = spec.get("names") or {}
    for f in ("kind", "plural", "singular"):
        if not names.get(f):
            raise CRDError(f"CRD missing names.{f}")
    if not _DNS1123_RE.match(crd.get("metadata", {}).get("name", "")):
        raise CRDError("CRD name is not a DNS-1123 subdomain")
    if spec.get("group") != CONSTRAINT_GROUP:
        raise CRDError(f"CRD group must be {CONSTRAINT_GROUP}")
    _check_schema(spec.get("validation", {}).get("openAPIV3Schema") or {}, "")


def _check_schema(schema: Any, path: str) -> None:
    if not isinstance(schema, dict):
        raise CRDError(f"schema node at {path or '/'} must be an object")
    ty = schema.get("type")
    if ty is not None and ty not in (
        "object", "array", "string", "integer", "number", "boolean", "null",
    ):
        raise CRDError(f"schema at {path or '/'}: unknown type {ty!r}")
    for key, sub in (schema.get("properties") or {}).items():
        _check_schema(sub, f"{path}.{key}")
    items = schema.get("items")
    if items is not None:
        if isinstance(items, list):
            for i, sub in enumerate(items):
                _check_schema(sub, f"{path}[{i}]")
        else:
            _check_schema(items, f"{path}[]")
    ap = schema.get("additionalProperties")
    if isinstance(ap, dict):
        _check_schema(ap, f"{path}.*")


# ----------------------------------------------------------------- CR checks


def validate_cr(cr: dict, crd: dict) -> None:
    """Validate a constraint instance against its generated CRD
    (reference crd_helpers.go validateCR)."""
    if not isinstance(cr, dict):
        raise CRDError("constraint must be an object")
    name = (cr.get("metadata") or {}).get("name") or ""
    if not name or len(name) > 253 or not _DNS1123_RE.match(name):
        raise CRDError(f"Invalid Name: {name!r} is not a DNS-1123 subdomain")
    spec = crd.get("spec") or {}
    want_kind = (spec.get("names") or {}).get("kind")
    if cr.get("kind") != want_kind:
        raise CRDError(
            f"Wrong kind for constraint {name}. Have {cr.get('kind')}, want {want_kind}"
        )
    api_version = cr.get("apiVersion") or ""
    group, _, version = api_version.partition("/")
    if group != CONSTRAINT_GROUP:
        raise CRDError(
            f"Wrong group for constraint {name}. Have {group}, want {CONSTRAINT_GROUP}"
        )
    if version not in SUPPORTED_CONSTRAINT_VERSIONS:
        raise CRDError(
            f"Wrong version for constraint {name}. Have {version}, "
            f"supported: {SUPPORTED_CONSTRAINT_VERSIONS}"
        )
    schema = (spec.get("validation") or {}).get("openAPIV3Schema")
    if schema:
        errs: list[str] = []
        _validate_value(cr, schema, "", errs)
        if errs:
            raise CRDError("; ".join(errs))


def _type_ok(value: Any, ty: str) -> bool:
    if ty == "object":
        return isinstance(value, dict)
    if ty == "array":
        return isinstance(value, list)
    if ty == "string":
        return isinstance(value, str)
    if ty == "boolean":
        return isinstance(value, bool)
    if ty == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if ty == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if ty == "null":
        return value is None
    return True


def _validate_value(value: Any, schema: dict, path: str, errs: list[str]) -> None:
    """openAPIV3Schema subset validator: type, properties, required, items,
    enum, additionalProperties, pattern, min/max(+Items/Length)."""
    if value is None:
        return  # null handled as missing, matching k8s structural defaults
    ty = schema.get("type")
    if ty and not _type_ok(value, ty):
        errs.append(f"{path or '/'}: expected {ty}")
        return
    enum = schema.get("enum")
    if enum is not None and value not in enum:
        errs.append(f"{path or '/'}: value {value!r} not in enum {enum!r}")
    if isinstance(value, dict):
        props = schema.get("properties") or {}
        for req in schema.get("required") or []:
            if req not in value:
                errs.append(f"{path or '/'}: missing required field {req!r}")
        ap = schema.get("additionalProperties")
        for k, v in value.items():
            if k in props:
                _validate_value(v, props[k], f"{path}.{k}", errs)
            elif isinstance(ap, dict):
                _validate_value(v, ap, f"{path}.{k}", errs)
            elif ap is False:
                errs.append(f"{path or '/'}: unexpected field {k!r}")
    elif isinstance(value, list):
        items = schema.get("items")
        if isinstance(items, dict):
            for i, v in enumerate(value):
                _validate_value(v, items, f"{path}[{i}]", errs)
        mn, mx = schema.get("minItems"), schema.get("maxItems")
        if mn is not None and len(value) < mn:
            errs.append(f"{path or '/'}: fewer than {mn} items")
        if mx is not None and len(value) > mx:
            errs.append(f"{path or '/'}: more than {mx} items")
    elif isinstance(value, str):
        pat = schema.get("pattern")
        if pat is not None and not re.search(pat, value):
            errs.append(f"{path or '/'}: does not match pattern {pat!r}")
        mn, mx = schema.get("minLength"), schema.get("maxLength")
        if mn is not None and len(value) < mn:
            errs.append(f"{path or '/'}: shorter than {mn}")
        if mx is not None and len(value) > mx:
            errs.append(f"{path or '/'}: longer than {mx}")
    elif isinstance(value, (int, float)) and not isinstance(value, bool):
        mn, mx = schema.get("minimum"), schema.get("maximum")
        if mn is not None and value < mn:
            errs.append(f"{path or '/'}: below minimum {mn}")
        if mx is not None and value > mx:
            errs.append(f"{path or '/'}: above maximum {mx}")
