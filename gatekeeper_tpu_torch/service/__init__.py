"""Policy service: localhost gRPC batch engine + remote client.

`python -m gatekeeper_tpu_torch.service` starts a resident engine serving the
Client surface (templates/constraints/data, batched Review, Audit) as
JSON-over-gRPC; RemoteClient is the drop-in counterpart. See
server.py for the wire contract and the rationale for JSON payloads.
"""

from .client import RemoteClient, RemoteTransportError
from .server import (
    INGEST_METHODS,
    SERVICE_NAME,
    PolicyService,
    make_server,
    serve,
)

__all__ = [
    "RemoteClient",
    "RemoteTransportError",
    "PolicyService",
    "SERVICE_NAME",
    "INGEST_METHODS",
    "make_server",
    "serve",
]
