"""Op registry: the one source of the flat op namespace.

Port of ``paddle_tpu/ops/registry.py``. An op is a function of torch
tensors registered once; ``make_op`` wraps it with ``dispatch`` and
``install_tensor_methods`` attaches its method form to ``Tensor``.

In-place variants (``x.add_(y)``, ``INPLACE_OPS``) are rebinds, as in
the reference (``registry.py:67-140``): the op runs on the tensor's
current value and the wrapper adopts its output, a new torch value whose
``grad_fn`` chains to the old one. No torch leaf is mutated; hooks move
with the wrapper (``Tensor._rebind``).
"""
from __future__ import annotations

import functools

import torch

from ..core.tensor import Tensor, dispatch

OPS = {}             # name -> callable (public op)
TENSOR_METHODS = {}  # method name -> callable


def make_op(name, fn, nondiff_args=()):
    @functools.wraps(fn)
    def op(*args, **kwargs):
        return dispatch(fn, *args, name=name, nondiff_args=nondiff_args,
                        **kwargs)

    op.__name__ = name
    op.__qualname__ = name
    OPS[name] = op
    return op


def register(name, *, method=None, nondiff_args=()):
    """Decorator form. ``method``: also expose as a Tensor method (True:
    the same name)."""

    def deco(fn):
        op = make_op(name, fn, nondiff_args=nondiff_args)
        if method:
            TENSOR_METHODS[name if method is True else method] = op
        return op

    return deco


def register_direct(name, fn, *, method=None):
    """Register an already-dispatching callable (control flow inside)."""
    OPS[name] = fn
    if method:
        TENSOR_METHODS[name if method is True else method] = fn
    return fn


# ops that also get an `x.<name>_()` in-place variant (the reference's list)
INPLACE_OPS = ("add", "subtract", "multiply", "divide", "scale", "clip",
               "exp", "sqrt", "rsqrt", "reciprocal", "floor", "ceil",
               "round", "trunc", "remainder", "lerp", "pow", "tanh",
               "sigmoid", "relu", "squeeze", "unsqueeze", "flatten",
               "flip", "cast", "reshape", "scatter", "index_add",
               "softmax", "elu")


def _mk_inplace(op):
    def method(self, *args, **kwargs):
        out = op(self, *args, **kwargs)
        self._rebind(out._value)
        return self
    return method


def _constant_rebind(self, value):
    """Bind to a constant of the old value's dtype: the result no longer
    depends on the old producer, so the graph is cut; the tensor stays
    trainable if it was."""
    old = self._value
    if old.requires_grad:
        value.requires_grad_(True)
    self._rebind(value)
    return self


def install_tensor_methods():
    for mname, op in TENSOR_METHODS.items():
        if not hasattr(Tensor, mname):
            setattr(Tensor, mname, op)
    for name in INPLACE_OPS:
        op = OPS.get(name)
        if op is not None and not hasattr(Tensor, name + "_"):
            setattr(Tensor, name + "_", _mk_inplace(op))

    def zero_(self):
        return _constant_rebind(self, torch.zeros_like(self._value))

    def fill_(self, value):
        return _constant_rebind(self, torch.full_like(self._value, value))

    if not hasattr(Tensor, "zero_"):
        Tensor.zero_ = zero_
    if not hasattr(Tensor, "fill_"):
        Tensor.fill_ = fill_


# Tensor-method parity tail: ops already registered become methods, and
# a few extra helpers are defined here (the reference's list).
_EXTRA_TENSOR_METHODS = (
    "cov", "corrcoef", "cond", "lstsq", "dist", "histogram", "bincount",
    "qr", "eigvals", "eigvalsh", "logcumsumexp", "logit", "increment",
    "stanh", "nansum", "nanmean", "count_nonzero", "amax", "amin",
    "fmax", "fmin", "kron", "lgamma", "equal_all", "is_empty",
    "expand_as", "scatter", "scatter_nd_add", "scatter_nd",
    "shard_index", "slice", "vsplit", "tensordot", "strided_slice",
    "unique_consecutive", "unstack", "rot90", "where", "index_sample",
    "digamma", "eig", "multi_dot", "solve", "cholesky_solve",
    "triangular_solve", "lu", "lu_unpack", "as_complex", "as_real",
    "gcd", "lcm", "angle", "take_along_axis", "put_along_axis",
    "heaviside", "index_add", "bucketize",
)


def install_method_tail():
    from . import random_ops
    for name in _EXTRA_TENSOR_METHODS:
        op = OPS.get(name)
        if op is not None and not hasattr(Tensor, name):
            setattr(Tensor, name, op)

    def broadcast_shape(self, y_shape):
        from .. import broadcast_shape as bs
        return bs(list(self.shape), y_shape)

    def broadcast_tensors_m(self, others=None):
        from .. import broadcast_tensors as bt
        return bt([self] + list(others or []))

    if not hasattr(Tensor, "broadcast_shape"):
        Tensor.broadcast_shape = broadcast_shape

    if not hasattr(Tensor, "broadcast_tensors"):
        Tensor.broadcast_tensors = broadcast_tensors_m

    def create_parameter(self, shape, dtype=None, **kw):
        """``paddle.create_parameter`` on the default place, as a method
        (the reference attaches it to ``Tensor`` too)."""
        from ..nn.layer import create_parameter as cp
        return cp(shape, dtype or "float32", **kw)

    if not hasattr(Tensor, "create_parameter"):
        Tensor.create_parameter = create_parameter

    for name in ("multiplex", "add_n", "concat", "stack"):
        # these ops take the tensor (or a list) as their first argument
        op = OPS.get(name)
        if op is not None and not hasattr(Tensor, name):
            setattr(Tensor, name, op)

    def floor_mod(self, y):
        return OPS["mod"](self, y)

    def rank(self):
        from .. import rank as rk
        return rk(self)

    def is_tensor(self):
        return True

    def is_complex(self):
        return self._value.is_complex()

    def is_integer(self):
        v = self._value
        return not (v.is_floating_point() or v.is_complex()
                    or v.dtype == torch.bool)

    def is_floating_point(self):
        return self._value.is_floating_point()

    def create_tensor(self, dtype=None):
        from ..core.tensor import to_tensor
        return to_tensor([], dtype=dtype or self.dtype,
                         place=self._value.device)

    for name, fn in [("floor_mod", floor_mod), ("rank", rank),
                     ("is_tensor", is_tensor), ("is_complex", is_complex),
                     ("is_integer", is_integer),
                     ("is_floating_point", is_floating_point),
                     ("uniform_", random_ops.uniform_),
                     ("exponential_", random_ops.exponential_),
                     ("erfinv_", _mk_inplace(OPS["erfinv"])),
                     ("put_along_axis_", _mk_inplace(OPS["put_along_axis"])),
                     ("create_tensor", create_tensor)]:
        if not hasattr(Tensor, name):
            setattr(Tensor, name, fn)
