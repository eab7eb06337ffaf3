"""paddle_tpu_torch.autograd: ``backward``, ``grad``, ``PyLayer``, and
the functional transforms ``vjp``, ``jvp``, ``jacobian``, ``hessian``.

Port of ``paddle_tpu/autograd/__init__.py`` over torch's autograd:
``grad`` is ``torch.autograd.grad`` (``.grad`` of the inputs is left as
it was, as the reference restores it), a ``PyLayer`` runs as a
``torch.autograd.Function`` whose backward calls the layer's, and the
functional transforms are ``torch.autograd.functional``'s, each over a
function of ``Tensor``s. ``saved_tensors_hooks`` applies, as in the
reference, to what a ``PyLayerContext`` saves.
"""
from __future__ import annotations

import torch

from ..core.tape import enable_grad, no_grad, set_grad_enabled, tape_enabled
from ..core.tensor import Tensor, backward as _tensor_backward, unwrap, wrap

__all__ = ["backward", "grad", "no_grad", "enable_grad", "set_grad_enabled",
           "is_grad_enabled", "PyLayer", "PyLayerContext", "vjp", "jvp",
           "jacobian", "hessian", "saved_tensors_hooks"]


def is_grad_enabled():
    return tape_enabled()


def backward(tensors, grad_tensors=None, retain_graph=False):
    if isinstance(tensors, Tensor):
        tensors = [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    elif isinstance(grad_tensors, Tensor):
        grad_tensors = [grad_tensors]
    for t, g in zip(tensors, grad_tensors):
        _tensor_backward(t, g, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: the gradients of ``outputs`` (seeded with ones, or
    ``grad_outputs``) with respect to ``inputs``. An input the outputs
    do not reach gets zeros, or None with ``allow_unused``."""
    outputs = [outputs] if isinstance(outputs, Tensor) else list(outputs)
    inputs = [inputs] if isinstance(inputs, Tensor) else list(inputs)
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    elif isinstance(grad_outputs, Tensor):
        grad_outputs = [grad_outputs]
    outs, seeds = [], []
    for o, g in zip(outputs, grad_outputs):
        v = o._value
        if v.requires_grad:
            outs.append(v)
            seeds.append(torch.ones_like(v) if g is None else unwrap(g))
    live = [i for i, p in enumerate(inputs) if p._value.requires_grad]
    got = [None] * len(inputs)
    if outs and live:
        res = torch.autograd.grad(
            outs, [inputs[i]._value for i in live], seeds,
            retain_graph=bool(retain_graph) or create_graph,
            create_graph=create_graph, allow_unused=True)
        for i, g in zip(live, res):
            got[i] = g
    grads = []
    for p, g in zip(inputs, got):
        if g is None:
            grads.append(None if allow_unused
                         else wrap(torch.zeros_like(p._value.detach())))
        else:
            grads.append(wrap(g))
    return grads


# ------------------------------------------------------------------ PyLayer


_saved_tensor_hooks = []   # stack of (pack, unpack)


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self._packed = None
        self._unpack_hook = None

    def save_for_backward(self, *tensors):
        # saved_tensors_hooks: pack at save time, remember the matching
        # unpack for use time
        if _saved_tensor_hooks:
            pack, unpack = _saved_tensor_hooks[-1]
            self._packed = tuple(pack(t) for t in tensors)
            self._unpack_hook = unpack
            self._saved = None
        else:
            self._packed = None
            self._unpack_hook = None
            self._saved = tensors

    def saved_tensor(self):
        if self._packed is not None:
            return tuple(self._unpack_hook(p) for p in self._packed)
        return self._saved

    saved_tensors = property(lambda self: self.saved_tensor())


def _flat_values(outs):
    if isinstance(outs, Tensor):
        return [outs._value]
    return [o._value for o in outs if isinstance(o, Tensor)]


class _PyLayerFunction(torch.autograd.Function):
    """One PyLayer application: ``layer.forward`` on Tensors over the
    torch inputs, ``layer.backward`` on Tensors over the incoming
    gradients (zeros for an output no gradient reached, as the
    reference fills them)."""

    @staticmethod
    def forward(fctx, layer, ctx, args, kwargs, positions, *vals):
        args = list(args)
        for p, v in zip(positions, vals):
            args[p] = wrap(v)
        outs = layer.forward(ctx, *args, **kwargs)
        ctx._outs = outs
        fctx.layer, fctx.ctx = layer, ctx
        fctx.float_in = [v.is_floating_point() or v.is_complex()
                         for v in vals]
        return tuple(_flat_values(outs))

    @staticmethod
    def backward(fctx, *gs):
        res = fctx.layer.backward(fctx.ctx, *[wrap(g) for g in gs])
        if isinstance(res, Tensor) or res is None:
            res = (res,)
        grads = []
        for i, is_float in enumerate(fctx.float_in):
            g = res[i] if i < len(res) else None
            grads.append(unwrap(g) if g is not None and is_float else None)
        return (None, None, None, None, None) + tuple(grads)


class PyLayer:
    """Custom autograd op (paddle.autograd.PyLayer): ``forward(ctx,
    *args)`` runs without recording, and ``backward(ctx, *grads)``
    returns one gradient for each Tensor argument, in order."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        positions = [i for i, a in enumerate(args) if isinstance(a, Tensor)]
        vals = [args[i]._value for i in positions]
        ctx = PyLayerContext()
        if not tape_enabled() or not any(v.requires_grad for v in vals):
            with no_grad():
                return cls.forward(ctx, *args, **kwargs)
        plain = tuple(None if isinstance(a, Tensor) else a for a in args)
        flat = iter(_PyLayerFunction.apply(cls, ctx, plain, kwargs,
                                           positions, *vals))
        outs = ctx._outs
        del ctx._outs
        if isinstance(outs, Tensor):
            return wrap(next(flat))
        return type(outs)(wrap(next(flat)) if isinstance(o, Tensor) else o
                          for o in outs)


# ------------------------------------------------------- functional autograd


def _as_fn(func):
    def fn(*vals):
        return _unwrap_tree(func(*[wrap(v) for v in vals]))
    return fn


def _unwrap_tree(x):
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, (tuple, list)):
        return type(x)(_unwrap_tree(o) for o in x)
    return x


def _wrap_tree(x):
    if isinstance(x, torch.Tensor):
        return wrap(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_wrap_tree(o) for o in x)
    return x


def _inputs(xs):
    xs_list = xs if isinstance(xs, (list, tuple)) else [xs]
    return tuple(unwrap(x).detach() for x in xs_list)


def vjp(func, xs, v=None):
    """(outputs, the vector-Jacobian products with ``v`` (ones by
    default)): one per input, or the one alone for a single input."""
    vals = _inputs(xs)
    fn = _as_fn(func)
    if v is None:
        with torch.no_grad():
            v = _ones_tree(fn(*vals))
    out, grads = torch.autograd.functional.vjp(fn, vals, _unwrap_tree(v))
    return _wrap_tree(out), _wrap_tree(grads if len(vals) > 1 else grads[0])


def _ones_tree(x):
    if isinstance(x, torch.Tensor):
        return torch.ones_like(x)
    return type(x)(_ones_tree(o) for o in x)


def jvp(func, xs, v=None):
    """(outputs, the Jacobian-vector products with ``v`` (ones by
    default))."""
    vals = _inputs(xs)
    if v is None:
        tangents = tuple(torch.ones_like(x) for x in vals)
    else:
        tangents = _inputs(v)
    out, tan = torch.autograd.functional.jvp(_as_fn(func), vals, tangents)
    return _wrap_tree(out), _wrap_tree(tan)


def jacobian(func, xs, create_graph=False):
    vals = _inputs(xs)
    jac = torch.autograd.functional.jacobian(_as_fn(func), vals,
                                             create_graph=create_graph)
    wrapped = _wrap_tree(jac)
    return wrapped if isinstance(xs, (list, tuple)) else (
        wrapped[0] if isinstance(wrapped, tuple) else wrapped)


def hessian(func, xs, create_graph=False):
    vals = _inputs(xs)
    h = torch.autograd.functional.hessian(_as_fn(func), vals,
                                          create_graph=create_graph)
    wrapped = _wrap_tree(h)
    return wrapped if isinstance(xs, (list, tuple)) else (
        wrapped[0] if isinstance(wrapped, tuple) else wrapped)


class saved_tensors_hooks:
    """paddle.autograd.saved_tensors_hooks: tensors stashed with
    ``PyLayerContext.save_for_backward`` go through ``pack_hook`` when
    saved and ``unpack_hook`` when used. Torch's own ops keep their
    residuals as the reference's ``jax.vjp`` closures do, out of the
    hooks' reach."""

    def __init__(self, pack_hook, unpack_hook):
        self.pack_hook = pack_hook
        self.unpack_hook = unpack_hook

    def __enter__(self):
        _saved_tensor_hooks.append((self.pack_hook, self.unpack_hook))
        return self

    def __exit__(self, *exc):
        _saved_tensor_hooks.pop()
        return False
