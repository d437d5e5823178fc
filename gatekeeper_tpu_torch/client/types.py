"""Validation result types.

Shape parity with the reference constraint framework's
types package (vendor/.../constraint/pkg/types/validation.go:11-99):
Result carries msg/metadata/constraint/review/resource/enforcement action,
Response groups results per target with optional trace/input dumps, and
Responses aggregates per-target responses for a Review/Audit call.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(slots=True)
class Result:
    msg: str = ""
    metadata: dict = field(default_factory=dict)
    # The constraint (unstructured dict) that was violated.
    constraint: Optional[dict] = None
    # The review object (gkReview-shaped dict) that produced the violation.
    review: Any = None
    # The violating resource, re-extracted from the review by the target
    # handler (reference pkg/target/target.go:193-244 HandleViolation).
    resource: Optional[dict] = None
    enforcement_action: str = "deny"

    def to_dict(self) -> dict:
        return {
            "msg": self.msg,
            "metadata": self.metadata,
            "constraint": self.constraint,
            "enforcementAction": self.enforcement_action,
        }


@dataclass
class Response:
    trace: Optional[str] = None
    input: Optional[str] = None
    target: str = ""
    results: list[Result] = field(default_factory=list)

    def trace_dump(self) -> str:
        parts = []
        if self.trace is not None:
            parts.append(f"Trace:\n{self.trace}")
        if self.input is not None:
            parts.append(f"Input:\n{self.input}")
        parts.append(f"Target: {self.target}")
        for r in self.results:
            parts.append(f"Result:\n{r.to_dict()}")
        return "\n\n".join(parts)


@dataclass
class Responses:
    by_target: dict[str, Response] = field(default_factory=dict)
    handled: dict[str, bool] = field(default_factory=dict)

    def results(self) -> list[Result]:
        out: list[Result] = []
        for _, resp in sorted(self.by_target.items()):
            out.extend(resp.results)
        return out

    def trace_dump(self) -> str:
        return "\n\n".join(
            resp.trace_dump() for _, resp in sorted(self.by_target.items())
        )


class ErrorMap(dict):
    """target name -> error; raised/returned alongside partial Responses."""

    def __str__(self) -> str:
        return "\n".join(f"{k}: {v}" for k, v in sorted(self.items()))


class ClientError(Exception):
    pass


class MissingTemplateError(ClientError):
    pass


class UnrecognizedConstraintError(ClientError):
    def __init__(self, kind: str):
        super().__init__(f"Constraint kind {kind} is not recognized")
        self.kind = kind
