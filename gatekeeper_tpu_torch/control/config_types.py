"""Config CRD helpers (config.gatekeeper.sh/v1alpha1).

Counterpart of the reference api/v1alpha1/config_types.go:22-92:
spec.sync.syncOnly lists the GVKs replicated into the driver inventory;
spec.validation.traces opts (user, kind) pairs into evaluation tracing.
"""

from __future__ import annotations

from typing import Optional

CONFIG_API_VERSION = "config.gatekeeper.sh/v1alpha1"


def config_crd() -> dict:
    """The Config CustomResourceDefinition manifest."""
    return {
        "apiVersion": "apiextensions.k8s.io/v1beta1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": "configs.config.gatekeeper.sh"},
        "spec": {
            "group": "config.gatekeeper.sh",
            "names": {"kind": "Config", "listKind": "ConfigList",
                      "plural": "configs", "singular": "config"},
            "scope": "Namespaced",
            "version": "v1alpha1",
            "versions": [{"name": "v1alpha1", "served": True,
                          "storage": True}],
            "subresources": {"status": {}},
            "validation": {"openAPIV3Schema": {"properties": {"spec": {
                "properties": {
                    "sync": {"properties": {"syncOnly": {
                        "type": "array",
                        "items": {"properties": {
                            "group": {"type": "string"},
                            "version": {"type": "string"},
                            "kind": {"type": "string"}}}}}},
                    "validation": {"properties": {"traces": {
                        "type": "array",
                        "items": {"properties": {
                            "user": {"type": "string"},
                            "kind": {"properties": {
                                "group": {"type": "string"},
                                "version": {"type": "string"},
                                "kind": {"type": "string"}}},
                            "dump": {"type": "string"}}}}}},
                }}}}},
        },
    }


def trace_enabled(traces: list, username: Optional[str],
                  gvk: tuple) -> tuple[bool, bool]:
    """(trace?, dump?) for a request, per the Config CRD's traces
    (reference policy.go:290-309)."""
    group, version, kind = gvk
    for t in traces or []:
        if not isinstance(t, dict):
            continue
        if t.get("user") and t.get("user") != username:
            continue
        tk = t.get("kind") or {}
        if tk.get("group", group) not in ("", group) and tk.get("group") != group:
            continue
        if tk.get("kind") and tk.get("kind") != kind:
            continue
        return True, (t.get("dump") == "All")
    return False, False
