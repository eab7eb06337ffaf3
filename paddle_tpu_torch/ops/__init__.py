"""Operators of the port.

- The flat op namespace of the paddle API (``creation``, ``math``,
  ``manipulation``, ``linalg``; port of ``paddle_tpu/ops/__init__.py``):
  every op is in ``registry.OPS``, reachable as ``ops.<name>`` and at
  the package's top level, and as a ``Tensor`` method where the
  reference has one, with ``Tensor``'s operator dunders, ``T`` and
  ``mT``. The ops are plain torch, as the reference's are jnp outside
  any Pallas kernel.
- ``optable``: the reference's declarative op table, copied (numpy and
  scipy only).
- rope (``rope``: the plain composition, and the opt-in route to its
  kernel) and the hand-written CUDA kernels under ``ops.kernels``.
"""
from ..core.tensor import Tensor, dispatch
from . import creation, linalg, manipulation, math  # noqa: F401
from .registry import OPS, install_tensor_methods

install_tensor_methods()

# -- operator dunders ---------------------------------------------------------
_b = OPS

Tensor.__add__ = lambda s, o: _b["add"](s, o)
Tensor.__radd__ = lambda s, o: _b["add"](s, o)
Tensor.__sub__ = lambda s, o: _b["subtract"](s, o)
Tensor.__rsub__ = lambda s, o: _b["subtract"](o, s)
Tensor.__mul__ = lambda s, o: _b["multiply"](s, o)
Tensor.__rmul__ = lambda s, o: _b["multiply"](s, o)
Tensor.__truediv__ = lambda s, o: _b["divide"](s, o)
Tensor.__rtruediv__ = lambda s, o: _b["divide"](o, s)
Tensor.__floordiv__ = lambda s, o: _b["floor_divide"](s, o)
Tensor.__mod__ = lambda s, o: _b["mod"](s, o)
Tensor.__pow__ = lambda s, o: _b["pow"](s, o)
Tensor.__rpow__ = lambda s, o: _b["pow"](o, s)
Tensor.__neg__ = lambda s: _b["neg"](s)
Tensor.__abs__ = lambda s: _b["abs"](s)
Tensor.__matmul__ = lambda s, o: _b["matmul"](s, o)
Tensor.__rmatmul__ = lambda s, o: _b["matmul"](o, s)
Tensor.__eq__ = lambda s, o: _b["equal"](s, o)
Tensor.__ne__ = lambda s, o: _b["not_equal"](s, o)
Tensor.__lt__ = lambda s, o: _b["less_than"](s, o)
Tensor.__le__ = lambda s, o: _b["less_equal"](s, o)
Tensor.__gt__ = lambda s, o: _b["greater_than"](s, o)
Tensor.__ge__ = lambda s, o: _b["greater_equal"](s, o)
Tensor.__and__ = lambda s, o: _b["logical_and"](s, o)
Tensor.__or__ = lambda s, o: _b["logical_or"](s, o)
Tensor.__xor__ = lambda s, o: _b["logical_xor"](s, o)
Tensor.__invert__ = lambda s: _b["logical_not"](s)

Tensor.T = property(lambda s: _b["t"](s))
Tensor.mT = property(lambda s: dispatch(lambda v: v.transpose(-1, -2), s))


def __getattr__(name):
    try:
        return OPS[name]
    except KeyError:
        raise AttributeError(
            f"module 'paddle_tpu_torch.ops' has no op {name!r}") from None


def __dir__():
    return sorted(set(list(globals()) + list(OPS)))
