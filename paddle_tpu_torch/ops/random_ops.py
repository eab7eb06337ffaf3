"""The random ops' names (``paddle_tpu/ops/random_ops.py``), not ported
yet: each raises ``NotImplementedError`` naming ROADMAP item 15.2. Their
draws must be ``jax.random``'s stream bit for bit, as the port's dropout
and sampling are (``core.prng``); ``randn``, ``normal`` and
``gaussian`` need XLA's f32 ``erfinv`` matched first."""
from .registry import register_direct

_NAMES = ("rand", "randn", "uniform", "normal", "gaussian", "randint",
          "randint_like", "randperm", "shuffle", "multinomial", "bernoulli",
          "poisson", "standard_normal", "rand_like",
          "randn_like")


def _pending(name):
    def op(*args, **kwargs):
        raise NotImplementedError(
            f"{name}: the random ops are not ported yet (ROADMAP Queue 1 "
            f"item 15.2)")
    op.__name__ = name
    return op


for _n in _NAMES:
    register_direct(_n, _pending(_n))
