"""Core runtime pieces of the port: the threefry generator bit for bit
with ``jax.random`` (``prng``) and the global RNG state over it
(``random``)."""
from . import prng, random

__all__ = ["prng", "random"]
