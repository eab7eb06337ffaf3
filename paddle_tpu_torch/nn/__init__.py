"""Neural-network operators and layers of the port: ``nn.functional``,
the subset of the JAX package's functional API that the Llama train step
calls, and ``nn.Linear``."""
from . import functional
from .layer import Linear

__all__ = ["functional", "Linear"]
