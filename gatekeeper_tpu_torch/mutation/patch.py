"""RFC-6902 JSONPatch generation (and application, for tests/round-trips).

The mutate webhook responds with the minimal add/replace/remove set
turning the request object into the mutated object (the reference
returns the same via admission.PatchResponseFromRaw → apimachinery's
CreateTwoWayMergePatch equivalent). Ops are emitted deterministically:
dict keys in sorted order, list tails removed highest-index-first so
the patch applies cleanly left to right.
"""

from __future__ import annotations

from typing import Any


def escape_pointer(seg: str) -> str:
    """RFC-6901 token escaping."""
    return seg.replace("~", "~0").replace("/", "~1")


def unescape_pointer(seg: str) -> str:
    return seg.replace("~1", "/").replace("~0", "~")


def _diff(before: Any, after: Any, path: str, ops: list[dict]) -> None:
    if before == after:
        return
    if isinstance(before, dict) and isinstance(after, dict):
        for k in sorted(before):
            if k not in after:
                ops.append({"op": "remove",
                            "path": f"{path}/{escape_pointer(str(k))}"})
        for k in sorted(after):
            sub = f"{path}/{escape_pointer(str(k))}"
            if k not in before:
                ops.append({"op": "add", "path": sub, "value": after[k]})
            else:
                _diff(before[k], after[k], sub, ops)
        return
    if isinstance(before, list) and isinstance(after, list):
        common = min(len(before), len(after))
        for i in range(common):
            _diff(before[i], after[i], f"{path}/{i}", ops)
        for i in range(common, len(after)):
            ops.append({"op": "add", "path": f"{path}/{i}",
                        "value": after[i]})
        for i in range(len(before) - 1, common - 1, -1):
            ops.append({"op": "remove", "path": f"{path}/{i}"})
        return
    ops.append({"op": "replace", "path": path, "value": after})


def json_patch(before: Any, after: Any) -> list[dict]:
    """RFC-6902 op list; [] when the objects are equal."""
    ops: list[dict] = []
    _diff(before, after, "", ops)
    return ops


def apply_patch(obj: Any, ops: list[dict]) -> Any:
    """Apply an RFC-6902 patch (add/replace/remove subset) to a deep copy
    of `obj` — the differential oracle for json_patch in tests."""
    import copy as _copy

    doc = _copy.deepcopy(obj)
    for op in ops:
        segs = [unescape_pointer(s) for s in op["path"].split("/")[1:]]
        if not segs:
            if op["op"] in ("add", "replace"):
                doc = _copy.deepcopy(op["value"])
                continue
            raise ValueError("cannot remove the whole document")
        parent = doc
        for s in segs[:-1]:
            parent = parent[int(s)] if isinstance(parent, list) else parent[s]
        leaf = segs[-1]
        kind = op["op"]
        if isinstance(parent, list):
            idx = len(parent) if leaf == "-" else int(leaf)
            if kind == "add":
                parent.insert(idx, _copy.deepcopy(op["value"]))
            elif kind == "replace":
                parent[idx] = _copy.deepcopy(op["value"])
            else:
                del parent[idx]
        else:
            if kind == "add" or kind == "replace":
                parent[leaf] = _copy.deepcopy(op["value"])
            else:
                del parent[leaf]
    return doc
