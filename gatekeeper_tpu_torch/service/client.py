"""Remote policy client: the Client surface over the gRPC service.

Mirrors gatekeeper_tpu_torch.client.Client method-for-method so callers (and
the driver-agnostic conformance suite, tests/test_client.py) can swap a
local client for a remote one unchanged. Errors re-raise as the exact
ClientError subclass the server hit, reconstructed from the JSON detail
envelope (server.py)."""

from __future__ import annotations

import json
from typing import Any, Optional

import grpc

from ..client.types import (
    ClientError,
    MissingTemplateError,
    Response,
    Responses,
    Result,
    UnrecognizedConstraintError,
)
from ..target import AugmentedReview, AugmentedUnstructured
from .server import SERVICE_NAME, _dumps, _loads

_ERRORS = {
    "ClientError": ClientError,
    "MissingTemplateError": MissingTemplateError,
    "UnrecognizedConstraintError": UnrecognizedConstraintError,
}

# only these codes carry the server's JSON error envelope; anything else
# (UNAVAILABLE, DEADLINE_EXCEEDED, ...) is a transport problem and must
# NOT masquerade as a policy validation failure
_ENVELOPE_CODES = (grpc.StatusCode.INVALID_ARGUMENT,
                   grpc.StatusCode.INTERNAL)


class RemoteTransportError(Exception):
    """The RPC itself failed (server down, timeout, ...). Deliberately NOT
    a ClientError: callers treating ClientError as 'the request was
    rejected' must not mistake an outage for a validation verdict."""

    def __init__(self, code, details: str):
        super().__init__(f"{code.name}: {details}")
        self.code = code


def _raise_remote(e: grpc.RpcError):
    if e.code() not in _ENVELOPE_CODES:
        raise RemoteTransportError(e.code(), e.details() or "") from e
    detail = e.details() or ""
    try:
        env = json.loads(detail)
    except (ValueError, TypeError):
        raise ClientError(detail) from None
    cls = _ERRORS.get(env.get("error"))
    if cls is UnrecognizedConstraintError:
        raise UnrecognizedConstraintError(env.get("kind") or "?") from None
    if cls is not None:
        raise cls(env.get("message", detail)) from None
    raise ClientError(env.get("message", detail)) from None


def _result_from_wire(d: dict) -> Result:
    return Result(
        msg=d.get("msg", ""),
        metadata=d.get("metadata") or {},
        constraint=d.get("constraint"),
        review=d.get("review"),
        resource=d.get("resource"),
        enforcement_action=d.get("enforcementAction") or "deny",
    )


def _responses_from_wire(d: dict) -> Responses:
    out = Responses()
    for name, resp in (d.get("byTarget") or {}).items():
        out.by_target[name] = Response(
            target=resp.get("target") or name,
            trace=resp.get("trace"),
            input=resp.get("input"),
            results=[_result_from_wire(r)
                     for r in resp.get("results") or []],
        )
    out.handled = d.get("handled") or {}
    return out


def _review_to_wire(obj: Any) -> dict:
    if isinstance(obj, AugmentedReview):
        item: dict = {"admissionRequest": obj.admission_request}
        if obj.namespace is not None:
            item["namespace"] = obj.namespace
        return item
    if isinstance(obj, AugmentedUnstructured):
        item = {"object": obj.object}
        if obj.namespace is not None:
            item["namespace"] = obj.namespace
        return item
    if isinstance(obj, dict):
        # plain dicts go as "raw" so the SERVER's target handler applies
        # its own duck-typing — wire-side classification would diverge
        # from the local Client (e.g. an unhandleable dict must come back
        # unhandled, not wrapped into an AugmentedUnstructured)
        return {"raw": obj}
    raise ClientError(f"cannot send review of type {type(obj).__name__}")


class RemoteClient:
    """gRPC-backed drop-in for gatekeeper_tpu_torch.client.Client."""

    def __init__(self, address: str,
                 channel: Optional[grpc.Channel] = None):
        self._channel = channel or grpc.insecure_channel(address)
        self._call = {}

    def close(self) -> None:
        self._channel.close()

    def _rpc(self, method: str, req: dict) -> dict:
        call = self._call.get(method)
        if call is None:
            call = self._channel.unary_unary(
                f"/{SERVICE_NAME}/{method}",
                request_serializer=_dumps,
                response_deserializer=_loads,
            )
            self._call[method] = call
        try:
            return call(req)
        except grpc.RpcError as e:
            _raise_remote(e)

    # ------------------------------------------------- lifecycle methods

    def add_template(self, template: dict) -> Responses:
        self._rpc("PutTemplate", {"template": template})
        return Responses()

    def remove_template(self, template: dict) -> Responses:
        self._rpc("RemoveTemplate", {"template": template})
        return Responses()

    def create_crd(self, template: dict) -> dict:
        return self._rpc("CreateCRD", {"template": template})["crd"]

    def add_constraint(self, constraint: dict) -> Responses:
        self._rpc("PutConstraint", {"constraint": constraint})
        return Responses()

    def remove_constraint(self, constraint: dict) -> Responses:
        self._rpc("RemoveConstraint", {"constraint": constraint})
        return Responses()

    def add_data(self, obj: Any) -> Responses:
        self._rpc("PutData", {"object": obj})
        return Responses()

    def remove_data(self, obj: Any) -> Responses:
        self._rpc("RemoveData", {"object": obj})
        return Responses()

    # ------------------------------------------------------- evaluation

    def review(self, obj: Any, tracing: bool = False) -> Responses:
        req = _review_to_wire(obj)
        if tracing:
            req["tracing"] = True
        return _responses_from_wire(self._rpc("Review", req))

    def review_batch(self, objs: list, tracing: bool = False
                     ) -> list[Responses]:
        req = {"reviews": [_review_to_wire(o) for o in objs]}
        if tracing:
            req["tracing"] = True
        return [_responses_from_wire(r)
                for r in self._rpc("ReviewBatch", req)["responses"]]

    def review_stream(self, batches, tracing: bool = False,
                      raw: bool = False):
        """STREAMING ingest: iterate over batches (each a list of
        review objects) and yield one list[Responses] per batch, in
        order, over a single pipelined HTTP/2 stream — no per-RPC
        round trip between batches. A per-batch server error raises
        the mapped ClientError for THAT batch when its result is
        consumed; the stream itself stays usable only up to the raise
        (iterate defensively for scan workloads).

        raw=True yields the wire response dicts untranslated (one
        list[dict] per batch, each `{"byTarget": ...}`): bulk scans
        flattening a million reviews to verdict pairs have no use for
        a million intermediate Result objects."""
        call = self._call.get("ReviewStream")
        if call is None:
            call = self._channel.stream_stream(
                f"/{SERVICE_NAME}/ReviewStream",
                request_serializer=_dumps,
                response_deserializer=_loads,
            )
            self._call["ReviewStream"] = call

        def requests():
            for objs in batches:
                req = {"reviews": [_review_to_wire(o) for o in objs]}
                if tracing:
                    req["tracing"] = True
                yield req

        try:
            for resp in call(requests()):
                err = resp.get("error")
                if err:
                    cls = _ERRORS.get(err.get("error"), ClientError)
                    if cls is UnrecognizedConstraintError:
                        raise cls(err.get("kind") or "?")
                    raise cls(err.get("message") or "stream batch failed")
                if raw:
                    yield resp.get("responses") or []
                else:
                    yield [_responses_from_wire(r)
                           for r in resp.get("responses") or []]
        except grpc.RpcError as e:
            _raise_remote(e)

    def audit(self, tracing: bool = False) -> Responses:
        req = {"tracing": True} if tracing else {}
        return _responses_from_wire(self._rpc("Audit", req))

    # ------------------------------------------------------------- misc

    def reset(self) -> None:
        self._rpc("Reset", {})

    def dump(self) -> str:
        return self._rpc("Dump", {})["dump"]

    def template_kinds(self) -> list[str]:
        return self._rpc("TemplateKinds", {})["kinds"]

    def knows_kind(self, kind: str) -> bool:
        return kind in self.template_kinds()
