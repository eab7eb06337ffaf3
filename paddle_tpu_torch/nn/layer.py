"""``nn.Layer``, its containers, and ``set_state_dict``: port of
``paddle_tpu/nn/layer.py``.

A ``Layer`` IS a ``torch.nn.Module`` and its parameters are
``torch.nn.Parameter``s, so everything that takes a module takes a layer
unchanged: the optimizer zoo, the clips, ``hapi.Model``,
``models.bridge``, ``torch.export``. The reference's API sits on top:

- ``create_parameter`` draws through the initializers (the global one of
  ``set_global_initializer`` over a layer's default, an attribute's over
  both; ``ParamAttr``'s ``name``, ``learning_rate`` and ``trainable``
  kept) and returns a ``ParamBase``: a ``torch.nn.Parameter`` that also
  answers the reference's ``Parameter`` API (``numpy()``,
  ``set_value``, ``stop_gradient``, ``trainable``, ``name``,
  ``optimize_attr``). ``pt.wrap(layer.weight)`` is a paddle ``Tensor``
  over the same leaf. A layer's parameters go to its ``device`` (the
  keyword of the layers that take one), else to the default place (the
  card unless ``set_device`` said otherwise; without a card it raises).
- Assigning a paddle ``Parameter`` (``core.tensor``) as an attribute
  registers its torch leaf: the ``Parameter`` and the layer then share
  one leaf, value and gradient.
- Calling a layer with a paddle ``Tensor`` among its inputs unwraps the
  inputs, runs ``forward`` on torch tensors and wraps the outputs back,
  so a ``Tensor`` in gives a ``Tensor`` out whose gradient reaches the
  layer's parameters; torch tensors in give torch tensors out and cost
  one type check an argument. A layer called on a ``static.Variable``
  while a program is being built is recorded as one op over its
  parameters (``static.graph``).
- ``register_forward_pre_hook`` / ``register_forward_post_hook`` keep the
  reference's hooks (they see the inputs as given) and return a
  ``HookRemoveHelper``; ``register_buffer(persistable=)``; the traversals
  (``parameters``, ``sublayers``, ``buffers`` and their ``named_``
  forms) return what the reference returns, in its order, and take
  torch's keywords as well; ``state_dict`` keeps the reference's
  structured names, each parameter once (under the first path that
  reaches it, as the reference), persistable buffers after them;
  ``astype`` / ``float`` / ``half`` / ``bfloat16`` cast the floating
  parameters only, as the reference does.
"""
import collections
import contextlib
import copy
import itertools

import numpy as np
import torch

from ..core import tensor as _core
from ..core.dtype import _STR2DTYPE, canonical, convert_dtype
from ..core.tensor import Parameter as _TensorParameter
from ..core.tensor import Tensor, _wrap_out
from ..device import default_device, place_to_device
from ..utils import unique_name
from . import initializer as I

__all__ = ["Layer", "LayerList", "Sequential", "ParameterList", "LayerDict",
           "HookRemoveHelper", "ParamBase", "set_state_dict",
           "create_parameter"]

class ParamBase(torch.nn.Parameter):
    """A layer's parameter: a ``torch.nn.Parameter`` with the reference
    ``Parameter``'s API. ``trainable`` and ``stop_gradient`` are views of
    ``requires_grad``; ``name`` and ``optimize_attr`` are kept through a
    deep copy."""

    def __new__(cls, data=None, requires_grad=True):
        p = super().__new__(cls, data, requires_grad)
        p._pname = None
        p.optimize_attr = {"learning_rate": 1.0}
        p.regularizer = None
        p.need_clip = True
        return p

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.requires_grad)
        memo[id(self)] = out
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out

    @property
    def name(self):
        return self.__dict__.get("_pname")

    @name.setter
    def name(self, value):
        self._pname = value

    @property
    def stop_gradient(self):
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, flag):
        self.requires_grad_(not flag)

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, flag):
        self.requires_grad_(bool(flag))

    def numpy(self):
        """A numpy copy of the value; bf16 comes out as f32, exactly."""
        v = self.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy().copy()

    @torch.no_grad()
    def set_value(self, value):
        """Copy ``value`` (a tensor, a paddle ``Tensor`` or an array) in,
        cast to this parameter's dtype and device."""
        v = value._value if isinstance(value, Tensor) else value
        if not torch.is_tensor(v):
            v = torch.from_numpy(np.array(v))
        self.copy_(v.detach().to(device=self.device, dtype=self.dtype))


@contextlib.contextmanager
def plain_parameters(*modules):
    """Within the block, every ``ParamBase`` of ``modules`` is a plain
    ``torch.nn.Parameter`` (its attributes kept): ``torch.export`` takes a
    tensor subclass it closes over as a constant for a value it cannot
    trace (``inference.deploy_decode`` holds its model that way)."""
    ps = [p for m in modules for p in m.parameters()
          if type(p) is ParamBase]
    for p in ps:
        p.__class__ = torch.nn.Parameter
    try:
        yield
    finally:
        for p in ps:
            p.__class__ = ParamBase


def _as_param(value):
    """``value`` as a ``ParamBase`` (None stays None): a ``ParamBase`` as
    it is; a torch tensor made a parameter over its storage; a paddle
    ``Parameter`` bound to the new leaf, which it shares from then on."""
    if value is None or isinstance(value, ParamBase):
        return value
    if isinstance(value, Tensor):
        p = ParamBase(value._value.detach(), not value.stop_gradient)
        p.name = value.name
        p.optimize_attr = dict(getattr(value, "optimize_attr",
                                       p.optimize_attr))
        value._rebind(p)
        return p
    if torch.is_tensor(value):
        trainable = value.requires_grad if isinstance(
            value, torch.nn.Parameter) else True
        return ParamBase(value.detach(), trainable)
    raise TypeError(f"cannot make a parameter of {type(value).__name__}")


def _has_tensor(items):
    for a in items:
        if isinstance(a, Tensor):
            return True
        if isinstance(a, (tuple, list)) and _has_tensor(a):
            return True
    return False


def _unwrap_tree(x):
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, list):
        return [_unwrap_tree(v) for v in x]
    if isinstance(x, tuple):
        items = [_unwrap_tree(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def _wrap_tree(x):
    if isinstance(x, torch.Tensor):
        return _wrap_out(x)
    if isinstance(x, list):
        return [_wrap_tree(v) for v in x]
    if isinstance(x, tuple):
        items = [_wrap_tree(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


class HookRemoveHelper:
    """The handle of a forward hook: ``remove()`` takes it out."""

    _ids = itertools.count()

    def __init__(self, hooks):
        self._hooks = hooks
        self._id = next(HookRemoveHelper._ids)

    def remove(self):
        self._hooks.pop(self._id, None)


class Layer(torch.nn.Module):
    """The paddle ``Layer`` over ``torch.nn.Module`` (module docstring)."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = canonical(convert_dtype(dtype)) or torch.float32
        self._place = None
        self._name_scope = name_scope or type(self).__name__.lower()
        # ``key_0``, ``key_1``, ... from utils.unique_name's one counter,
        # which static's names share (the reference's)
        self._full_name = unique_name.generate(self._name_scope)
        self._pre_hooks = collections.OrderedDict()
        self._post_hooks = collections.OrderedDict()

    def full_name(self):
        """The unique name of this layer (``linear_0``, ...); a deep copy
        keeps the original's."""
        return self._full_name

    @property
    def _sub_layers(self):
        return self._modules

    # ------------------------------------------------------------ attributes
    def __setattr__(self, name, value):
        if isinstance(value, _TensorParameter):
            value = _as_param(value)
        elif isinstance(value, Tensor):
            value = value._value
        super().__setattr__(name, value)

    # ------------------------------------------------------------ creation
    def _param_device(self):
        return self._place if self._place is not None else default_device()

    def create_parameter(self, shape, dtype=None, default_initializer=None,
                         attr=None, is_bias=False, *, draw=True):
        """A new ``ParamBase`` of ``shape`` on this layer's device, drawn
        by the initializer the reference would choose; ``draw=False``
        leaves it empty and keeps the initializer for ``init_parameter``
        (a layer whose ``reset_parameters`` draws)."""
        dt = canonical(convert_dtype(dtype)) or self._dtype
        init = default_initializer
        g = I.get_global_initializer(is_bias)
        if g is not None:
            init = g
        if isinstance(attr, I.Initializer):
            init = attr
        elif attr is not None and getattr(attr, "initializer",
                                          None) is not None:
            init = attr.initializer
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierNormal()
        shape = tuple(int(s) for s in shape)
        dev = self._param_device()
        value = init(shape, dt, dev) if draw else torch.empty(
            shape, dtype=dt, device=dev)
        p = ParamBase(value)
        p._initializer = init
        if attr is not None and getattr(attr, "name", None):
            p.name = attr.name
        if attr is not None and getattr(attr, "learning_rate",
                                        None) is not None:
            p.optimize_attr["learning_rate"] = attr.learning_rate
        if attr is not None and getattr(attr, "trainable", True) is False:
            p.trainable = False
        return p

    @staticmethod
    @torch.no_grad()
    def init_parameter(p):
        """Draw ``p`` by the initializer ``create_parameter`` chose."""
        p.copy_(p._initializer(tuple(p.shape), p.dtype, p.device))

    def add_parameter(self, name, parameter):
        self.register_parameter(name, _as_param(parameter))
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        if isinstance(tensor, Tensor):
            tensor = tensor._value
        elif tensor is not None and not torch.is_tensor(tensor):
            tensor = torch.tensor(np.asarray(tensor),
                                  device=self._param_device())
        super().register_buffer(
            name, tensor, persistable if persistent is None else persistent)
        return tensor

    # ------------------------------------------------------------ traversal
    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=None, remove_duplicate=True):
        return super().named_parameters(
            prefix=prefix,
            recurse=include_sublayers if recurse is None else recurse,
            remove_duplicate=remove_duplicate)

    def parameters(self, include_sublayers=True, recurse=None):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_sublayers(self, prefix="", include_self=False):
        return [(n, m) for n, m in self.named_modules(prefix=prefix)
                if include_self or m is not self]

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_buffers(self, prefix="", include_sublayers=True, recurse=None,
                      remove_duplicate=True):
        return super().named_buffers(
            prefix=prefix,
            recurse=include_sublayers if recurse is None else recurse,
            remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=None):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers, recurse=recurse)]

    def apply(self, fn):
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    # ------------------------------------------------------------ mode/dtype
    def to(self, *args, **kwargs):
        """``to(device=None, dtype=None, blocking=None)`` in the
        reference's order (a paddle place or a torch device), or torch's
        forms; a dtype casts the floating parameters (``astype``)."""
        device = kwargs.pop("device", None)
        dtype = kwargs.pop("dtype", None)
        kwargs.pop("blocking", None)
        for a in args:
            if isinstance(a, torch.dtype) or (
                    isinstance(a, str) and a in _STR2DTYPE):
                dtype = a
            elif a is not None and not isinstance(a, bool):
                device = a
        if device is not None:
            dev = device if isinstance(device, torch.device) else \
                place_to_device(device)
            super().to(dev, **kwargs)
            self._place = dev
            for m in self.modules():
                if isinstance(m, Layer):
                    m._place = dev
        if dtype is not None:
            self.astype(dtype)
        return self

    def astype(self, dtype):
        dt = canonical(convert_dtype(dtype))
        with torch.no_grad():
            for p in self.parameters():
                if p.is_floating_point() and p.dtype != dt:
                    p.data = p.data.to(dt)
        self._dtype = dt
        return self

    def float(self):
        return self.astype("float32")

    def half(self):
        return self.astype("float16")

    def bfloat16(self):
        return self.astype("bfloat16")

    # ------------------------------------------------------------ hooks
    def register_forward_pre_hook(self, hook):
        """``hook(layer, inputs)`` before ``forward``; a return other than
        None replaces the inputs."""
        helper = HookRemoveHelper(self._pre_hooks)
        self._pre_hooks[helper._id] = hook
        return helper

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)`` after ``forward``; a return
        other than None replaces the outputs."""
        helper = HookRemoveHelper(self._post_hooks)
        self._post_hooks[helper._id] = hook
        return helper

    # ------------------------------------------------------------ call
    def __call__(self, *inputs, **kwargs):
        for hook in list(self._pre_hooks.values()):
            out = hook(self, inputs)
            if out is not None:
                inputs = out if isinstance(out, tuple) else (out,)
        paddle = _has_tensor(inputs) or _has_tensor(kwargs.values())
        rec = _core._static_recorder
        if paddle and rec is not None and rec.active(inputs, kwargs):
            outputs = rec.record_layer(self, inputs, kwargs)
        elif paddle:
            outputs = _wrap_tree(super().__call__(
                *_unwrap_tree(inputs),
                **{k: _unwrap_tree(v) for k, v in kwargs.items()}))
        else:
            outputs = super().__call__(*inputs, **kwargs)
        for hook in list(self._post_hooks.values()):
            res = hook(self, inputs, outputs)
            if res is not None:
                outputs = res
        return outputs

    # ------------------------------------------------------------ state dict
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *, prefix=None,
                   keep_vars=True):
        """name -> tensor: each parameter once under the reference's
        structured name, then the persistable buffers. The tensors are
        the layer's own (``keep_vars=False``, as torch passes it from a
        parent module, detaches them)."""
        if prefix is not None:
            structured_name_prefix = prefix[:-1] if prefix.endswith(".") \
                else prefix
        dest = destination if destination is not None else \
            collections.OrderedDict()
        pre = structured_name_prefix
        for name, p in self.named_parameters(
                prefix=pre, include_sublayers=include_sublayers):
            dest[name] = p if keep_vars else p.detach()
        layers = self.named_sublayers(prefix=pre, include_self=True) \
            if include_sublayers else [(pre, self)]
        for name, layer in layers:
            for bname, b in layer._buffers.items():
                if b is None or bname in layer._non_persistent_buffers_set:
                    continue
                key = f"{name}.{bname}" if name else bname
                dest[key] = b if keep_vars else b.detach()
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        return set_state_dict(self, state_dict, use_structured_name)

    load_dict = set_state_dict

    # ------------------------------------------------------------ functional
    def raw_params(self):
        """name -> tensor of the trainable parameters."""
        return {n: p for n, p in self.named_parameters() if p.requires_grad}

    @torch.no_grad()
    def load_raw_params(self, params):
        named = dict(self.named_parameters())
        for n, v in params.items():
            named[n].copy_(v._value if isinstance(v, Tensor) else v)


@torch.no_grad()
def set_state_dict(module, state_dict, use_structured_name=True):
    """``Layer.set_state_dict`` on any torch module: every entry of
    ``state_dict`` (a tensor, a paddle ``Tensor`` or an array, under the
    names of ``module.state_dict()``: parameters and persistent buffers)
    is copied into the module's own tensor, cast to its dtype and device.
    Returns ``(missing, unexpected)`` names, as the reference does; a
    shape that differs raises ValueError before anything is copied."""
    own = module.state_dict(keep_vars=True)
    missing = [k for k in own if k not in state_dict]
    unexpected = [k for k in state_dict if k not in own]
    vals = {}
    for k, v in state_dict.items():
        if k not in own:
            continue
        t = v._value if isinstance(v, Tensor) else v
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.array(t))
        if tuple(t.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: shape {tuple(t.shape)} does not match "
                             f"the layer's {tuple(own[k].shape)}")
        vals[k] = t
    for k, t in vals.items():
        own[k].copy_(t.detach().to(device=own[k].device, dtype=own[k].dtype))
    return missing, unexpected


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """paddle.create_parameter: a ``ParamBase`` on the default place."""
    from .param_attr import ParamAttr
    attr = ParamAttr._to_attr(attr)
    if name is not None and attr is None:
        attr = ParamAttr(name=name)
    p = Layer().create_parameter(shape, dtype, default_initializer,
                                 attr if attr is not False else None,
                                 is_bias)
    if name is not None:
        p.name = name
    return p


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            for i, layer in enumerate(sublayers):
                self.add_sublayer(str(i), layer)

    def append(self, sublayer):
        self.add_sublayer(str(len(self._modules)), sublayer)
        return self

    def insert(self, index, sublayer):
        layers = list(self._modules.values())
        layers.insert(index, sublayer)
        self._modules.clear()
        for i, layer in enumerate(layers):
            self._modules[str(i)] = layer

    def extend(self, sublayers):
        for layer in sublayers:
            self.append(layer)
        return self

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return list(self._modules.values())[idx]
        return self._modules[str(idx if idx >= 0 else len(self) + idx)]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            for k, v in sublayers.items():
                self.add_sublayer(k, v)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, sublayers):
        for k, v in sublayers.items():
            self.add_sublayer(k, v)
