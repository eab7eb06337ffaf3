"""Neural-network operators of the port: ``nn.functional``, the subset
of the JAX package's functional API that the Llama train step calls."""
from . import functional

__all__ = ["functional"]
