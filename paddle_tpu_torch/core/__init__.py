"""Core runtime pieces of the port: the threefry generator bit for bit
with ``jax.random`` (``prng``), the global RNG state over it
(``random``), and the paddle API's tensor core: ``dtype`` (the names and
the reference's 64-bit-off narrowing), ``tape`` (grad mode) and
``tensor`` (``Tensor``, ``Parameter``, ``to_tensor``, ``dispatch``)."""
from . import dtype, prng, random, tape, tensor

__all__ = ["dtype", "prng", "random", "tape", "tensor"]
