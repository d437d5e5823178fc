"""Admission hot-path JSON: orjson when available, stdlib fallback.

The serving plane decodes and encodes one JSON document per admission
request; on the reference line that cost is Go's encoding/json, here it
is the difference between ~50us (orjson's C encoder) and ~250us
(stdlib) per review at webhook payload sizes. orjson is OPTIONAL — the
container image may not carry it — so every entry point degrades to the
stdlib implementation with identical semantics:

  loads(bytes|str)      -> obj        (raises ValueError subtypes)
  dumps_bytes(obj)      -> bytes      (compact separators)
  canonical_bytes(obj)  -> bytes      (sorted keys, compact — the
                                       decision-cache request hash must
                                       not depend on dict insert order)
"""

from __future__ import annotations

import json
from typing import Any

try:  # pragma: no cover - exercised only where orjson is installed
    import orjson as _orjson
except ImportError:  # the baked image has no orjson; stdlib serves
    _orjson = None

BACKEND = "orjson" if _orjson is not None else "stdlib"


if _orjson is not None:  # pragma: no cover - image-dependent
    def loads(data) -> Any:
        return _orjson.loads(data)

    def dumps_bytes(obj: Any) -> bytes:
        return _orjson.dumps(obj)

    def canonical_bytes(obj: Any) -> bytes:
        return _orjson.dumps(obj, default=str,
                             option=_orjson.OPT_SORT_KEYS)
else:
    def loads(data) -> Any:
        if isinstance(data, (bytes, bytearray, memoryview)):
            data = bytes(data).decode("utf-8")
        return json.loads(data)

    def dumps_bytes(obj: Any) -> bytes:
        return json.dumps(obj, separators=(",", ":")).encode("utf-8")

    def canonical_bytes(obj: Any) -> bytes:
        return json.dumps(obj, separators=(",", ":"), sort_keys=True,
                          default=str).encode("utf-8")
