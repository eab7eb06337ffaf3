"""The eager ``Tensor`` of the paddle API over a ``torch.Tensor``.

Port of ``paddle_tpu/core/tensor.py``. A ``Tensor`` is a thin Python
wrapper holding a ``torch.Tensor`` (``_value``); torch's autograd
records the graph, in place of the reference's tape of ``jax.vjp``
closures (``tensor.py:172-251``) and its reverse walk (``:254``).

- ``stop_gradient`` is ``not value.requires_grad``. Setting it on a
  leaf switches ``requires_grad``; setting it to True on a non-leaf
  detaches the value, which cuts the graph there. A type that cannot
  carry a gradient (integers, bool) keeps the flag on the wrapper, so
  ``stop_gradient=False`` on it is accepted, as the reference accepts
  it, and records nothing.
- ``grad`` is a ``Tensor`` over the torch leaf's ``.grad``; a non-leaf
  has none, as in the reference.
- Every op goes through ``dispatch``: unwrap, the AMP O1 casts
  (``amp.cast_inputs_for_op``, the reference's ``:193``), the op on
  torch tensors, the NaN/Inf scan when ``set_nan_inf_check`` is on, and
  the outputs wrapped. The reference's arrays are never 64-bit (JAX's
  x64 is off), so every output is narrowed by ``dtype.canonical``.
- Values are treated as immutable, as JAX arrays are: an in-place
  method (``registry.INPLACE_OPS``), ``set_value`` and ``__setitem__``
  bind the wrapper to a new torch value (``_rebind``); no torch leaf is
  mutated. Hooks (``register_hook``) belong to the wrapper and move to
  each new value, so they fire on the gradient of the tensor as it is
  after the rebind.

The reference's static recorder (``tensor.py:182``):
``set_static_recorder`` installs ``static.graph``'s recorder, which
takes an op that touches a symbolic ``static.Variable`` into the
program being built instead of running it. While none is installed,
``dispatch`` pays one test of a module global for it. The reference's
``param_substitution`` (``:43``) has no counterpart: the port's
``jit.functional_call`` runs a layer, a ``torch.nn.Module``, through
``torch.func.functional_call``.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .. import amp as _amp
from ..device import default_device, place_to_device
from . import dtype as dtypes
from .tape import no_grad

__all__ = [
    "Tensor", "Parameter", "to_tensor", "dispatch", "unwrap", "wrap",
    "backward", "no_grad", "set_nan_inf_check", "set_static_recorder",
]

_NARROW = dtypes._NARROW


_static_recorder = None     # static.graph's recorder while one is installed


def set_static_recorder(recorder):
    """Install ``recorder`` (``active(args, kwargs)``, ``record(fn,
    args, kwargs, name=, nondiff_args=)``) at the top of ``dispatch``;
    None removes it."""
    global _static_recorder
    _static_recorder = recorder


def unwrap(x):
    """Tensor -> its torch value; anything else as it is."""
    return x._value if isinstance(x, Tensor) else x


def wrap(value):
    """A ``Tensor`` over the torch tensor ``value`` (no copy); its
    ``stop_gradient`` is ``not value.requires_grad``."""
    t = Tensor.__new__(Tensor)
    t._value = value
    t.name = None
    t._hooks = None
    t._hook_handle = None
    t._sg = True
    return t


def _canon(value):
    c = _NARROW.get(value.dtype)
    return value if c is None else value.to(c)


def _wrap_out(out):
    if isinstance(out, torch.Tensor):
        return wrap(_canon(out))
    if isinstance(out, tuple):
        return tuple(_wrap_out(o) for o in out)
    if isinstance(out, list):
        return [_wrap_out(o) for o in out]
    return out


def _canon_out(out):
    if isinstance(out, torch.Tensor):
        return _canon(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_canon_out(o) for o in out)
    return out


def as_value(data, dtype=None, device=None):
    """``data`` (a Tensor, a torch tensor, a numpy array or Python data)
    as a torch tensor in the reference's canonical dtype. A torch value
    keeps its device unless ``device`` is given; other data goes to
    ``device`` or the default place (the card unless ``set_device``
    said otherwise)."""
    if isinstance(data, Tensor):
        data = data._value
    if isinstance(data, torch.Tensor):
        v = data.detach()
    else:
        arr = np.asarray(data)
        if arr.dtype.name == "bfloat16":      # ml_dtypes, where present
            v = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            v = torch.tensor(arr)
        if device is None:
            device = default_device()
    target = dtypes.canonical(dtypes.convert_dtype(dtype) or v.dtype)
    if device is not None or v.dtype != target:
        v = v.to(device=device, dtype=target)
    return v


_hook_counter = [0]


def _next_hook_id():
    _hook_counter[0] += 1
    return _hook_counter[0]


class _HookHandle:
    """Removable handle returned by ``Tensor.register_hook``."""

    __slots__ = ("_hooks", "_hid")

    def __init__(self, hooks, hid):
        self._hooks = hooks
        self._hid = hid

    def remove(self):
        if self._hooks is None:
            return False
        for i, (hid, _fn) in enumerate(self._hooks):
            if hid == self._hid:
                del self._hooks[i]
                self._hooks = None
                return True
        self._hooks = None
        return False


class _Rebind(torch.autograd.Function):
    """Value ``new``, gradient passed to ``old`` unchanged: the
    reference's rebind of a non-leaf, whose tape node stays as it was
    (``set_value``, ``__setitem__``)."""

    @staticmethod
    def forward(ctx, old, new):
        return new.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


_check_nan_inf = False      # FLAGS_check_nan_inf
_check_nan_inf_level = 0    # 0 = raise, >=1 = warn


def _flag_truthy(v):
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    return s not in ("", "0", "false", "no", "off", "none")


def set_nan_inf_check(enabled, level=0):
    """Scan every op's floating outputs for NaN/Inf (the reference's
    ``FLAGS_check_nan_inf``, ``tensor.py:138``): level 0 raises
    ``FloatingPointError``, level 1 or more warns. Accepts bools and the
    env strings ('1'/'true'/'false'/...)."""
    global _check_nan_inf, _check_nan_inf_level
    _check_nan_inf = _flag_truthy(enabled)
    try:
        _check_nan_inf_level = int(str(level))
    except (TypeError, ValueError):
        _check_nan_inf_level = 1 if _flag_truthy(level) else 0


def _leaves(out):
    if isinstance(out, (tuple, list)):
        for o in out:
            yield from _leaves(o)
    else:
        yield out


def _nan_inf_scan(name, out):
    for v in _leaves(out):
        if isinstance(v, torch.Tensor) and v.is_floating_point() \
                and not bool(torch.isfinite(v).all()):
            msg = (f"Operator {name or '<anonymous>'} output contains "
                   f"Inf/Nan: {int(torch.isnan(v).sum())} nan, "
                   f"{int(torch.isinf(v).sum())} inf "
                   f"(shape {tuple(v.shape)})")
            if _check_nan_inf_level >= 1:
                warnings.warn(msg)
            else:
                raise FloatingPointError(msg)


def dispatch(fn, *args, name=None, nondiff_args=(), **kwargs):
    """Run ``fn`` (a function of torch tensors) on the unwrapped ``args``.

    Positions in ``nondiff_args`` are detached (index inputs). numpy
    arrays among the arguments become torch tensors on the first
    tensor's device. Returns Tensors (a tuple or list of them for a
    tuple or list) when any argument was a Tensor, torch values
    otherwise; either way in the canonical dtypes. An installed static
    recorder takes the op when it is ``active`` for ``args``."""
    if _static_recorder is not None and _static_recorder.active(
            args, kwargs):
        return _static_recorder.record(fn, args, kwargs, name=name,
                                       nondiff_args=nondiff_args)
    any_tensor = False
    device = None
    has_np = False
    vals = list(args)
    for i, a in enumerate(args):
        if isinstance(a, Tensor):
            any_tensor = True
            v = a._value
            vals[i] = v.detach() if i in nondiff_args else v
            if device is None:
                device = v.device
        elif isinstance(a, torch.Tensor):
            if device is None:
                device = a.device
        elif isinstance(a, np.ndarray):
            has_np = True
    if has_np:
        vals = [as_value(v, device=device) if isinstance(v, np.ndarray)
                else v for v in vals]
    if kwargs:
        for k, a in kwargs.items():
            if isinstance(a, Tensor):
                any_tensor = True
                kwargs[k] = a._value
    st = _amp.amp_state()
    if st.enabled:
        vals = _amp.cast_inputs_for_op(
            name or getattr(fn, "__name__", ""), vals, st)
    out = fn(*vals, **kwargs)
    if _check_nan_inf:
        _nan_inf_scan(name or getattr(fn, "__name__", None), out)
    if not any_tensor:
        return _canon_out(out)
    return _wrap_out(out)


def backward(tensor, grad_tensor=None, retain_graph=False):
    """Backpropagate from ``tensor`` (seeded with ones, or
    ``grad_tensor``) through torch's autograd into every leaf's
    ``.grad``. A tensor that records no graph is a no-op, as in the
    reference."""
    v = tensor._value
    if not v.requires_grad:
        return
    g = torch.ones_like(v) if grad_tensor is None else \
        as_value(grad_tensor, dtype=v.dtype, device=v.device)
    torch.autograd.backward(v, g, retain_graph=retain_graph)


class Tensor:
    """Eager tensor. Value semantics follow paddle.Tensor where sensible."""

    __slots__ = ("_value", "name", "_hooks", "_hook_handle", "_sg",
                 "__weakref__")

    def __init__(self, value, dtype=None, stop_gradient=True, name=None,
                 place=None):
        self._value = as_value(value, dtype, place_to_device(place))
        self.name = name
        self._hooks = None
        self._hook_handle = None
        self._sg = True
        if not stop_gradient:
            self.stop_gradient = False

    # -- structural properties ------------------------------------------------
    @property
    def shape(self):
        return list(self._value.shape)

    @property
    def ndim(self):
        return self._value.dim()

    @property
    def dtype(self):
        return self._value.dtype

    @property
    def size(self):
        return self._value.numel()

    @property
    def is_leaf(self):
        return self._value.grad_fn is None

    @property
    def value(self):
        return self._value

    @property
    def stop_gradient(self):
        return False if self._value.requires_grad else self._sg

    @stop_gradient.setter
    def stop_gradient(self, flag):
        flag = bool(flag)
        v = self._value
        if not (v.is_floating_point() or v.is_complex()):
            self._sg = flag
            return
        if flag == (not v.requires_grad):
            return
        if v.grad_fn is None:
            v.requires_grad_(not flag)
            if self._hooks and not flag:
                self._install_hooks()
        else:
            self._rebind(v.detach())

    @property
    def grad(self):
        v = self._value
        if v.grad_fn is not None or v.grad is None:
            return None
        return wrap(v.grad)

    @grad.setter
    def grad(self, g):
        if self._value.grad_fn is None:
            self._value.grad = None if g is None else unwrap(g)

    def numpy(self):
        """A numpy copy of the value; bf16 comes out as float32, exactly
        (numpy has no bfloat16 on the card's host)."""
        v = self._value.detach()
        if v._is_zerotensor():
            v = torch.zeros(v.shape, dtype=v.dtype, device=v.device)
        if v.dtype == torch.bfloat16:
            v = v.float()
        if v.is_conj():
            v = v.resolve_conj()
        if v.device.type == "cpu":
            return v.numpy().copy()
        return v.cpu().numpy()

    def item(self):
        return self._value.item()

    def tolist(self):
        return self.numpy().tolist()

    def __len__(self):
        return self._value.shape[0]

    def __repr__(self):
        return (
            f"Tensor(shape={self.shape}, dtype="
            f"{dtypes.dtype_name(self.dtype)}, place={self._value.device}, "
            f"stop_gradient={self.stop_gradient},\n{self.numpy()})"
        )

    def __hash__(self):
        return id(self)

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]

    def __bool__(self):
        return bool(self._value)

    def __float__(self):
        return float(self._value)

    def __int__(self):
        return int(self._value)

    def __format__(self, spec):
        if self.ndim == 0:
            return format(self.item(), spec)
        return repr(self)

    # -- autograd -------------------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph=False):
        backward(self, grad_tensor, retain_graph)

    def clear_grad(self):
        self.grad = None

    def clear_gradient(self):
        self.grad = None

    def detach(self):
        return wrap(self._value.detach())

    def clone(self):
        return dispatch(torch.clone, self, name="clone")

    def register_hook(self, hook):
        """``hook(grad) -> Tensor|None`` runs during backward on this
        tensor's gradient, once, when a gradient reaches it; a non-None
        return replaces the gradient. Returns a removable handle."""
        if self.stop_gradient:
            raise RuntimeError(
                "register_hook on a tensor with stop_gradient=True has no "
                "effect; set stop_gradient=False first")
        hid = _next_hook_id()
        if self._hooks is None:
            self._hooks = []
        self._hooks.append((hid, hook))
        if self._hook_handle is None and self._value.requires_grad:
            self._install_hooks()
        return _HookHandle(self._hooks, hid)

    def _install_hooks(self):
        hooks = self._hooks

        def run(g):
            if g is None:      # no gradient reached this output
                return None
            for _hid, h in list(hooks):
                r = h(wrap(g))
                if r is not None:
                    g = unwrap(r)
            return g

        self._hook_handle = self._value.register_hook(run)

    def _rebind(self, value):
        """Bind this wrapper to the torch tensor ``value``; its hooks
        move along."""
        h = self._hook_handle
        if h is not None:
            h.remove()
            self._hook_handle = None
        self._value = value
        if self._hooks and value.requires_grad:
            self._install_hooks()

    # -- mutation (rebinds; no torch value changes) ---------------------------
    def set_value(self, value):
        """Replace the value, keeping dtype and device. A leaf stays a
        leaf (its ``grad`` kept); a non-leaf keeps its producer, whose
        gradient passes through unchanged (the reference keeps the tape
        node)."""
        old = self._value
        new = as_value(value, device=old.device).to(old.dtype)
        if old.grad_fn is None:
            new = new.clone()
            if old.requires_grad:
                new.requires_grad_(True)
                new.grad = old.grad
            self._rebind(new)
        else:
            self._rebind(_Rebind.apply(old, new))

    def copy_(self, other):
        self.set_value(other)
        return self

    def _replace_value(self, value):
        self._rebind(value)

    # Methods attached by paddle_tpu_torch.ops (astype, reshape, matmul,
    # sum, mean, ...): ops/registry.py:install_tensor_methods.


class Parameter(Tensor):
    """Trainable tensor: a torch leaf that requires grad unless
    ``trainable=False``."""

    __slots__ = ("trainable", "optimize_attr", "regularizer",
                 "is_distributed", "no_sync", "_sharding_axes")

    def __init__(self, value, dtype=None, name=None, trainable=True):
        super().__init__(value, dtype=dtype, stop_gradient=not trainable,
                         name=name)
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.is_distributed = False
        self.no_sync = False
        self._sharding_axes = None


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: ``data`` copied to ``place`` (None: the default
    place, the card unless ``set_device("cpu")``; a torch tensor or
    Tensor keeps its device), in the reference's canonical dtype."""
    return Tensor(data, dtype=dtype, stop_gradient=stop_gradient,
                  place=place)
