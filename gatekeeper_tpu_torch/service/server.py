"""gRPC batch policy service at the Client/Driver seam.

The communication backend of the framework (SURVEY.md §2.5): a resident
policy engine process serving template/constraint/data lifecycle plus
batched Review and Audit over localhost gRPC — the role the reference
embeds in its controller process behind the Driver interface
(vendor/github.com/open-policy-agent/frameworks/constraint/pkg/client/
drivers/interface.go:21-39).

Wire format: UTF-8 JSON request/response bodies over unary gRPC methods
(service `gatekeeper.v1.Policy`). JSON instead of protobuf is deliberate:
the payloads ARE Kubernetes unstructured objects (templates, constraints,
AdmissionReviews), which k8s itself serializes as JSON; no generated stubs
or .proto toolchain is needed, and the messages stay human-debuggable
(`grpcurl -plaintext -d '{...}'` works out of the box).

Errors cross the wire as INVALID_ARGUMENT with a JSON detail envelope
{"error": <exception class>, "message": ...} so the remote client
(service/client.py) can re-raise the exact ClientError subclass —
conformance-tested by running the driver-agnostic e2e suite
(tests/test_client.py) over a live localhost server.

Streaming ingest (ROADMAP item 5): `ReviewStream` is a bidirectional
stream of the same ReviewBatch wire messages — bulk callers (CI
scanners, service-mesh authorizers) keep ONE HTTP/2 stream open and
pipeline batch after batch without per-RPC setup, connection churn, or
HTTP/1.1 framing. Per-batch failures answer an {"error": ...} message
on the stream instead of aborting it, so one malformed batch cannot
kill a million-manifest scan.
"""

from __future__ import annotations

import json
import logging
import threading
from concurrent import futures
from typing import Any, Optional

import grpc

from ..client import Backend, Client, RegoDriver
from ..client.types import ClientError, Responses, Result
from ..control import jsonio
from ..ir import TorchDriver
from ..target import (
    AugmentedReview,
    AugmentedUnstructured,
    K8sValidationTarget,
)

log = logging.getLogger("gatekeeper_tpu_torch.service")

SERVICE_NAME = "gatekeeper.v1.Policy"


# ------------------------------------------------------------------ codec
# jsonio rides orjson when the image carries it (~5x less codec CPU on
# the batched review path — the messages ARE the payload here) and
# degrades to the stdlib with identical wire bytes semantics


def _dumps(obj: Any) -> bytes:
    return jsonio.dumps_bytes(obj)


def _loads(data: bytes) -> Any:
    return jsonio.loads(data)


def result_to_wire(r: Result) -> dict:
    return {
        "msg": r.msg,
        "metadata": r.metadata,
        "constraint": r.constraint,
        "review": r.review,
        "resource": r.resource,
        "enforcementAction": r.enforcement_action,
    }


def responses_to_wire(resps: Responses) -> dict:
    return {
        "byTarget": {
            name: {
                "target": resp.target,
                "trace": resp.trace,
                "input": resp.input,
                "results": [result_to_wire(r) for r in resp.results],
            }
            for name, resp in resps.by_target.items()
        },
        "handled": resps.handled,
    }


def _wrap_review(item: dict) -> Any:
    """Reconstruct the review argument from its wire form:
    {"object": ...} | {"admissionRequest": ...} | {"raw": ...} (plain dict
    left to the target handler's own duck-typing), optional "namespace"."""
    ns = item.get("namespace")
    if "admissionRequest" in item:
        return AugmentedReview(admission_request=item["admissionRequest"],
                               namespace=ns)
    if "object" in item:
        return AugmentedUnstructured(object=item["object"], namespace=ns)
    if "raw" in item:
        return item["raw"]
    raise ClientError(
        "review item needs 'object', 'admissionRequest', or 'raw'")


# ---------------------------------------------------------------- service


class PolicyService:
    """Method handlers over one resident Client. Client methods already
    lock internally; handlers are therefore safe under gRPC's thread
    pool."""

    def __init__(self, client: Client):
        self.client = client

    # every handler: dict -> dict (JSON roundtrip handled by the codec)

    def put_template(self, req: dict) -> dict:
        self.client.add_template(req["template"])
        return {"ok": True}

    def remove_template(self, req: dict) -> dict:
        self.client.remove_template(req["template"])
        return {"ok": True}

    def create_crd(self, req: dict) -> dict:
        return {"crd": self.client.create_crd(req["template"])}

    def put_constraint(self, req: dict) -> dict:
        self.client.add_constraint(req["constraint"])
        return {"ok": True}

    def remove_constraint(self, req: dict) -> dict:
        self.client.remove_constraint(req["constraint"])
        return {"ok": True}

    def put_data(self, req: dict) -> dict:
        self.client.add_data(req["object"])
        return {"ok": True}

    def remove_data(self, req: dict) -> dict:
        self.client.remove_data(req["object"])
        return {"ok": True}

    def review(self, req: dict) -> dict:
        resps = self.client.review(_wrap_review(req),
                                   tracing=bool(req.get("tracing")))
        return responses_to_wire(resps)

    def review_batch(self, req: dict) -> dict:
        """Batched admission: one RPC, many reviews — the micro-batcher's
        wire form. Routes through Client.review_batch so the driver's
        vectorized evaluation amortizes the whole batch (per-item
        Client.review here forfeited the batching the RPC exists for)."""
        tracing = bool(req.get("tracing"))
        objs = [_wrap_review(item) for item in req.get("reviews", [])]
        resps = self.client.review_batch(objs, tracing=tracing)
        return {"responses": [responses_to_wire(r) for r in resps]}

    def review_stream(self, request_iterator, context):
        """Streaming ingest: each inbound message is one ReviewBatch
        request; each outbound message is its ReviewBatch response (or
        a per-batch {"error": ...} — the stream survives bad batches).
        Batches pipeline on one HTTP/2 stream: the caller needs no
        per-RPC round trip, and the engine sees back-to-back batches."""
        for req in request_iterator:
            try:
                yield self.review_batch(req)
            except ClientError as e:
                yield {"error": {"error": type(e).__name__,
                                 "message": str(e),
                                 "kind": getattr(e, "kind", None)}}
            except Exception as e:  # keep the stream alive; log it
                log.exception("internal error in ReviewStream batch")
                yield {"error": {"error": "InternalError",
                                 "message": str(e)}}

    def audit(self, req: dict) -> dict:
        return responses_to_wire(
            self.client.audit(tracing=bool(req.get("tracing"))))

    def reset(self, req: dict) -> dict:
        self.client.reset()
        return {"ok": True}

    def dump(self, req: dict) -> dict:
        return {"dump": self.client.dump()}

    def template_kinds(self, req: dict) -> dict:
        return {"kinds": self.client.template_kinds()}


_METHODS = {
    "PutTemplate": "put_template",
    "RemoveTemplate": "remove_template",
    "CreateCRD": "create_crd",
    "PutConstraint": "put_constraint",
    "RemoveConstraint": "remove_constraint",
    "PutData": "put_data",
    "RemoveData": "remove_data",
    "Review": "review",
    "ReviewBatch": "review_batch",
    "Audit": "audit",
    "Reset": "reset",
    "Dump": "dump",
    "TemplateKinds": "template_kinds",
}

# read-only evaluation surface for the Runtime's --ingest-grpc
# endpoint: bulk callers get Review/ReviewBatch/ReviewStream (and kind
# discovery), never the library lifecycle — an unauthenticated ingest
# port must not be able to rewrite the serving policy library
INGEST_METHODS = ("Review", "ReviewBatch", "ReviewStream",
                  "TemplateKinds")


def _make_handler(service: PolicyService, attr: str):
    method = getattr(service, attr)

    def handle(request: dict, context: grpc.ServicerContext) -> dict:
        try:
            return method(request)
        except ClientError as e:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                json.dumps({"error": type(e).__name__, "message": str(e),
                            "kind": getattr(e, "kind", None)}))
        except Exception as e:  # internal: never leak a stack over the wire
            log.exception("internal error in %s", attr)
            context.abort(grpc.StatusCode.INTERNAL,
                          json.dumps({"error": "InternalError",
                                      "message": str(e)}))

    return grpc.unary_unary_rpc_method_handler(
        handle, request_deserializer=_loads, response_serializer=_dumps)


def make_server(client: Optional[Client] = None, address: str = "127.0.0.1:0",
                driver: str = "torch", max_workers: int = 8,
                expose: Optional[tuple] = None, device: str = "cuda"):
    """-> (grpc.Server, bound_port). Caller starts/stops the server.
    `expose` restricts the served method set (e.g. INGEST_METHODS for
    the Runtime's evaluation-only bulk ingest port). `device` is the
    torch device of the driver built here: cuda (the card; raises where
    none is visible) or cpu."""
    if client is None:
        drv = (TorchDriver(device=device) if driver == "torch"
               else RegoDriver())
        client = Backend(drv).new_client([K8sValidationTarget()])
    service = PolicyService(client)
    handlers = {name: _make_handler(service, attr)
                for name, attr in _METHODS.items()
                if expose is None or name in expose}
    if expose is None or "ReviewStream" in expose:
        handlers["ReviewStream"] = grpc.stream_stream_rpc_method_handler(
            service.review_stream,
            request_deserializer=_loads, response_serializer=_dumps)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        # no SO_REUSEPORT: two engines silently sharing a port would split
        # traffic unpredictably; a second bind must FAIL (checked below)
        options=(("grpc.so_reuseport", 0),))
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),))
    port = server.add_insecure_port(address)
    if port == 0:
        # grpc signals bind failure by returning port 0; serving anyway
        # would block forever on an address nobody reaches
        raise OSError(f"could not bind policy service to {address}")
    return server, port


def serve(address: str = "127.0.0.1:50061", driver: str = "torch",
          device: str = "cuda") -> None:
    """Blocking entry point (`python -m gatekeeper_tpu_torch.service`)."""
    server, port = make_server(address=address, driver=driver,
                               device=device)
    server.start()
    log.info("policy service listening on port %d (driver=%s)", port, driver)
    stop = threading.Event()
    try:
        stop.wait()
    except KeyboardInterrupt:
        server.stop(grace=2.0)
