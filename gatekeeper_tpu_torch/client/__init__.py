from .client import Backend, Client
from .drivers import Driver, RegoDriver
from .templates import CONSTRAINT_GROUP, ConstraintTemplate, load_template
from .types import (
    ClientError,
    MissingTemplateError,
    Response,
    Responses,
    Result,
    UnrecognizedConstraintError,
)

__all__ = [
    "Backend",
    "Client",
    "CONSTRAINT_GROUP",
    "ConstraintTemplate",
    "ClientError",
    "Driver",
    "load_template",
    "MissingTemplateError",
    "RegoDriver",
    "Response",
    "Responses",
    "Result",
    "UnrecognizedConstraintError",
]
