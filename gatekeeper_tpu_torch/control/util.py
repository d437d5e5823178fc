"""Control-plane utilities.

Counterparts of the reference pkg/util: GVK-packed reconcile requests
(pack.go:16-57), enforcement-action validation (enforcement_action.go:11-45),
pod identity (pod_info.go), and byPod HA status helpers (ha_status.go:14-50,
util/constraint/unstructured_ha_status.go:19-133).
"""

from __future__ import annotations

import os
from typing import Optional

VALID_ENFORCEMENT_ACTIONS = ("deny", "dryrun", "warn")
DEFAULT_ENFORCEMENT_ACTION = "deny"


class UnrecognizedEnforcementAction(Exception):
    pass


def validate_enforcement_action(action: str) -> None:
    if action not in VALID_ENFORCEMENT_ACTIONS:
        raise UnrecognizedEnforcementAction(
            f"Invalid enforcement action {action!r}; must be one of "
            f"{VALID_ENFORCEMENT_ACTIONS}"
        )


# ------------------------------------------------------- packed GVK requests


def pack_request(gvk: tuple, name: str, namespace: str = "") -> str:
    """Encode GVK + object identity into one watch-event request token
    (the reference packs GVK into reconcile request names, pack.go)."""
    group, version, kind = gvk
    ns_part = f"{namespace}/" if namespace else ""
    return f"{group}|{version}|{kind}|{ns_part}{name}"


def unpack_request(token: str) -> tuple[tuple, str, str]:
    group, version, kind, rest = token.split("|", 3)
    if "/" in rest:
        namespace, name = rest.split("/", 1)
    else:
        namespace, name = "", rest
    return (group, version, kind), name, namespace


# ---------------------------------------------------------------- pod info

# explicit identity overrides (--pod-name/--pod-namespace flags): byPod
# statuses must carry the STABLE downward-API pod identity, not whatever
# hostname the process happens to see — a replaced pod then overwrites
# its own status slot instead of accumulating one per restart
_POD_NAME_OVERRIDE: Optional[str] = None
_POD_NAMESPACE_OVERRIDE: Optional[str] = None


def set_pod_identity(name: Optional[str] = None,
                     namespace: Optional[str] = None) -> None:
    global _POD_NAME_OVERRIDE, _POD_NAMESPACE_OVERRIDE
    if name:
        _POD_NAME_OVERRIDE = name
    if namespace:
        _POD_NAMESPACE_OVERRIDE = namespace


def pod_name() -> str:
    if _POD_NAME_OVERRIDE:
        return _POD_NAME_OVERRIDE
    return os.environ.get("POD_NAME", os.environ.get("HOSTNAME", "gatekeeper"))


def pod_namespace() -> str:
    if _POD_NAMESPACE_OVERRIDE:
        return _POD_NAMESPACE_OVERRIDE
    return os.environ.get("POD_NAMESPACE", "gatekeeper-system")


# ------------------------------------------------------------ byPod status


def get_by_pod_status(obj: dict) -> Optional[dict]:
    """This pod's entry in status.byPod (HA: each replica owns one slot)."""
    status = obj.get("status") or {}
    for entry in status.get("byPod") or []:
        if isinstance(entry, dict) and entry.get("id") == pod_name():
            return entry
    return None


def set_by_pod_status(obj: dict, entry: dict) -> None:
    """Upsert this pod's status entry, preserving other pods' entries."""
    entry = dict(entry)
    entry["id"] = pod_name()
    status = obj.setdefault("status", {})
    by_pod = [e for e in status.get("byPod") or []
              if not (isinstance(e, dict) and e.get("id") == pod_name())]
    by_pod.append(entry)
    by_pod.sort(key=lambda e: e.get("id") or "")
    status["byPod"] = by_pod


def delete_by_pod_status(obj: dict) -> None:
    status = obj.get("status") or {}
    by_pod = [e for e in status.get("byPod") or []
              if not (isinstance(e, dict) and e.get("id") == pod_name())]
    status["byPod"] = by_pod


def prune_stale_by_pod(obj: dict, live_ids: set) -> bool:
    """Drop byPod entries whose pod id is not in `live_ids` (pods that
    no longer exist — their statuses must be garbage-collected, not
    accumulate forever as replicas churn). Returns True when any entry
    was pruned (the caller must write the status back)."""
    status = obj.get("status") or {}
    by_pod = status.get("byPod") or []
    kept = [e for e in by_pod
            if not isinstance(e, dict) or e.get("id") in live_ids]
    if len(kept) == len(by_pod):
        return False
    obj.setdefault("status", {})["byPod"] = kept
    return True


def by_pod_status_unchanged(obj: dict, entry: dict) -> bool:
    """True when this pod's existing byPod entry already equals `entry`
    (ignoring the id field) — lets controllers skip no-op status writes
    that would loop MODIFIED events back into their own queues."""
    cur = get_by_pod_status(obj)
    return cur is not None and {**cur, "id": None} == {**entry, "id": None}
