"""Typed failures, copied from the JAX package's reliability layer (the
ones the server raises)."""
from .errors import (CallbackError, DeadlineExceeded,  # noqa: F401
                     QueueFullError, ReliabilityError, RequestCancelled,
                     ServerClosed)

__all__ = ["ReliabilityError", "DeadlineExceeded", "QueueFullError",
           "RequestCancelled", "ServerClosed", "CallbackError"]
