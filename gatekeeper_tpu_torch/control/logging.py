"""Structured logging.

Key names mirror the reference pkg/logging/logging.go:3-20 so downstream
log pipelines keyed on those fields keep working; output is JSON lines
(the reference uses zap's JSON encoder in production, main.go:254-269).
"""

from __future__ import annotations

import json
import logging
import sys
import time

# structured keys (reference logging.go)
PROCESS = "process"
DETAILS = "details"
EVENT_TYPE = "event_type"
TEMPLATE_NAME = "template_name"
CONSTRAINT_NAME = "constraint_name"
CONSTRAINT_GROUP = "constraint_group"
CONSTRAINT_API_VERSION = "constraint_api_version"
CONSTRAINT_KIND = "constraint_kind"
CONSTRAINT_ACTION = "constraint_action"
CONSTRAINT_STATUS = "constraint_status"
RESOURCE_GROUP = "resource_group"
RESOURCE_KIND = "resource_kind"
RESOURCE_API_VERSION = "resource_api_version"
RESOURCE_NAMESPACE = "resource_namespace"
RESOURCE_NAME = "resource_name"
REQUEST_USERNAME = "request_username"
DEBUG_LEVEL = 1  # zap's debug verbosity analog


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "level": record.levelname.lower(),
            "ts": round(time.time(), 3),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        extra = getattr(record, "structured", None)
        if extra:
            entry.update(extra)
        if record.exc_info:
            entry["error"] = self.formatException(record.exc_info)
        return json.dumps(entry, default=str)


def setup(level: str = "INFO", stream=None) -> None:
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(JsonFormatter())
    root = logging.getLogger("gatekeeper")
    root.handlers[:] = [handler]
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.propagate = False


def logger(name: str) -> "StructuredLogger":
    return StructuredLogger(logging.getLogger(f"gatekeeper.{name}"))


class StructuredLogger:
    def __init__(self, base: logging.Logger):
        self._base = base

    def _log(self, level: int, msg: str, kv: dict) -> None:
        self._base.log(level, msg, extra={"structured": kv})

    def info(self, msg: str, **kv) -> None:
        self._log(logging.INFO, msg, kv)

    def debug(self, msg: str, **kv) -> None:
        self._log(logging.DEBUG, msg, kv)

    def warning(self, msg: str, **kv) -> None:
        self._log(logging.WARNING, msg, kv)

    def error(self, msg: str, **kv) -> None:
        self._log(logging.ERROR, msg, kv)
