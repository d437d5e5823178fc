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
    "ControllerManager",
    "FakeKube",
    "MicroBatcher",
    "NamespaceLabelHandler",
    "RestKubeClient",
    "ValidationHandler",
    "WatchManager",
    "WebhookServer",
]
