from .audit import AuditManager
from .controllers import ControllerManager
from .kube import FakeKube, RestKubeClient
from .watch import WatchManager
from .webhook import (
    MicroBatcher,
    NamespaceLabelHandler,
    ValidationHandler,
    WebhookServer,
)

__all__ = [
    "AuditManager",
    "ControllerManager",
    "FakeKube",
    "MicroBatcher",
    "NamespaceLabelHandler",
    "RestKubeClient",
    "ValidationHandler",
    "WatchManager",
    "WebhookServer",
]
