"""``paddle.jit``: ``functional_call``, ``to_static`` and
``TranslatedLayer``, ``grad_and_loss``, ``train_step_fn``, ``save`` /
``load``, and the switches.

Port of ``paddle_tpu/jit/__init__.py``. The reference ``jax.jit``s what
it converts; the port runs it eagerly, so a converted layer or function
launches the hand-written kernels (K4, K5, K6) exactly where the eager
path does and gives the eager path's numbers bit for bit (no
``torch.compile``, which would route around the kernels). What the
reference compiles, the port exports: ``save`` with an ``input_spec``
writes a ``torch.export`` archive (``inference.export_layer``), and
``jit.dy2static`` turns a converted function's tensor-dependent control
flow into ``torch.cond`` / ``while_loop`` while it is exported.

- ``functional_call(layer, params, *args)`` runs the layer with the
  given parameter (and buffer) values through
  ``torch.func.functional_call``; gradients flow to the given values.
- ``to_static(layer)`` is a ``TranslatedLayer`` (a fresh
  ``next_key()`` each call, as the reference's ``:134``);
  ``to_static(fn)`` converts ``fn``'s control flow (``dy2static``). Both
  run under ``no_grad`` and return what the reference's compiled call
  returns: values that carry no gradient.
- ``grad_and_loss(layer, loss_fn)`` is ``(params, batch, rng) -> (loss,
  grads)`` by ``torch.autograd.grad`` over a functional call, the
  counterpart of ``jax.value_and_grad``: the kernels' backward (K4b, K5b,
  K6's) run as in the eager step.
- ``train_step_fn`` is the port's in-place step (below).
"""
import contextlib
import functools
import os

import torch

from ..core import random as rnd
from ..core.tape import no_grad
from ..core.tensor import unwrap
from ..nn.layer import _unwrap_tree, _wrap_tree

__all__ = ["functional_call", "to_static", "TranslatedLayer",
           "grad_and_loss", "train_step_fn", "not_to_static", "save", "load",
           "ignore_module", "enable_to_static", "set_verbosity",
           "set_code_level"]


def _raw_params(module):
    """``{name: parameter}`` of a module's trainable parameters
    (``Layer.raw_params()``, for any ``torch.nn.Module``)."""
    return {n: p for n, p in module.named_parameters() if p.requires_grad}


def functional_call(layer, params, *args, rng=None, buffers=None, **kwargs):
    """Run ``layer(*args, **kwargs)`` with its parameters taken from
    ``params`` (``{name: tensor}``, as ``layer.raw_params()`` names them;
    a parameter left out keeps its own value) and its buffers from
    ``buffers``; random ops draw under ``rng_scope(rng)`` when ``rng`` is
    given. Returns torch tensors (the reference's raw arrays),
    differentiable w.r.t. the given values."""
    values = {n: unwrap(v) for n, v in params.items()}
    if buffers:
        values.update({n: unwrap(v) for n, v in buffers.items()})
    ctx = rnd.rng_scope(rng) if rng is not None else contextlib.nullcontext()
    with ctx:
        out = torch.func.functional_call(
            layer, values, _unwrap_tree(args),
            {k: _unwrap_tree(v) for k, v in kwargs.items()})
    return _unwrap_tree(out)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """``paddle.jit.to_static``: a ``TranslatedLayer`` for a layer; for a
    function, its ``dy2static`` conversion, run under ``no_grad`` (the
    original eagerly while ``enable_to_static(False)``)."""
    def decorate(fn):
        if isinstance(fn, torch.nn.Module):
            return TranslatedLayer(fn)
        from .dy2static import convert_to_static
        static_fn = convert_to_static(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            if not _to_static_enabled[0]:
                return fn(*args, **kw)
            with no_grad():
                return static_fn(*args, **kw)

        return wrapper

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    fn._not_to_static = True
    return fn


class TranslatedLayer:
    """A converted layer (the reference's StaticFunction /
    PartialProgramLayer): each call is ``functional_call`` over the
    layer's trainable parameters and buffers under a fresh
    ``next_key()``, in the layer's training mode, under ``no_grad``;
    outputs come back as paddle Tensors. Other attributes are the
    layer's."""

    def __init__(self, layer):
        self._layer = layer

    @property
    def layer(self):
        return self._layer

    def __call__(self, *args, **kwargs):
        params = _raw_params(self._layer)
        buffers = dict(self._layer.named_buffers())
        key = rnd.next_key()
        with no_grad():
            out = functional_call(self._layer, params, *args, rng=key,
                                  buffers=buffers, **kwargs)
        return _wrap_tree(out)

    def __getattr__(self, name):
        return getattr(self._layer, name)


def grad_and_loss(layer, loss_fn):
    """``compute(params, batch, rng=None) -> (loss, grads)``: the loss of
    ``loss_fn(functional_call(layer, params, *batch, rng=rng))`` and its
    gradients w.r.t. ``params`` (``{name: tensor}``, zeros where the loss
    does not depend on one), as ``jax.value_and_grad`` gives them."""

    def compute(params, batch, rng=None):
        leaves = {n: unwrap(v).detach().requires_grad_(True)
                  for n, v in params.items()}
        with torch.enable_grad():
            out = functional_call(layer, leaves, *batch, rng=rng)
            loss = unwrap(loss_fn(out))
        names = list(leaves)
        gs = torch.autograd.grad(loss, [leaves[n] for n in names],
                                 allow_unused=True)
        grads = {n: torch.zeros_like(leaves[n]) if g is None else g
                 for n, g in zip(names, gs)}
        return loss.detach(), grads

    return compute


def train_step_fn(layer, loss_fn, optimizer):
    """``step(batch) -> loss``: ``loss_fn(layer(*batch["inputs"]),
    *batch.get("labels", ()))``, ``loss.backward()``,
    ``optimizer.step()``, ``optimizer.clear_grad()``.

    Counterpart of the reference's ``train_step_fn``, which traces
    forward, backward and update into one jitted program over ``(params,
    opt_state, batch, step)`` and returns the new parameters and state;
    here torch's autograd takes the place of the reference's tape and the
    step updates the layer's parameters, and the optimizer its state, IN
    PLACE; the returned loss is detached from the graph. The step honours
    the optimizer's ``grad_clip`` and learning-rate scheduler through
    ``optimizer.step()``: the clip's own ``clip_values`` inside the
    update, as the reference's ``Optimizer.step`` does. The reference's
    ``train_step_fn`` instead always clips by the global norm, reading
    ``grad_clip.clip_norm`` (``jit/__init__.py:166-170``); the two agree
    for ``ClipGradByGlobalNorm`` (ROADMAP, Queue 3). The caller steps the
    scheduler. Under ``amp.auto_cast`` the step's operators cast their
    inputs as the reference's dispatch does."""

    def step(batch):
        out = layer(*batch["inputs"])
        loss = loss_fn(out, *batch.get("labels", ()))
        loss.backward()
        optimizer.step()
        optimizer.clear_grad()
        return loss.detach()

    return step


def save(layer, path, input_spec=None, **configs):
    """``paddle.jit.save``: the layer's state dict (``<path>.pdparams``)
    and, given ``input_spec``, its forward exported in eval mode
    (``<path>.pdmodel`` / ``.pdmeta``, ``inference.export_layer``)."""
    from ..io.save_load import save as _save
    if isinstance(layer, TranslatedLayer):
        layer = layer.layer
    state = layer.state_dict() if hasattr(layer, "state_dict") else layer
    _save(state, path + ".pdparams")
    if input_spec is not None and isinstance(layer, torch.nn.Module):
        from ..inference.export import export_layer
        export_layer(path, layer, input_spec)


def load(path, **configs):
    """The archive at ``path`` as a callable ``ExportedProgram`` on
    ``configs["device"]`` (the default place when not given) when
    ``jit.save`` exported one; otherwise the saved state dict."""
    if os.path.exists(path + ".pdmodel"):
        from ..device import default_device
        from ..inference.export import load_exported
        dev = configs.get("device") or default_device()
        prog, _, _ = load_exported(path, device=dev)
        return prog
    from ..io.save_load import load as _load
    return _load(path + ".pdparams")


# ------------------------------------------------- the switches
# (the reference's python/paddle/jit/api.py and dy2static logging_utils)

_ignored_modules = []
_to_static_enabled = [True]


def ignore_module(modules):
    """Functions defined in the listed modules are never converted by
    ``to_static`` (``dy2static.convert_to_static`` reads the list)."""
    if not isinstance(modules, (list, tuple)):
        modules = [modules]
    _ignored_modules.extend(modules)
    return _ignored_modules


def enable_to_static(flag=True):
    """While off, ``to_static`` functions run their original code."""
    _to_static_enabled[0] = bool(flag)


_verbosity = [0]
_code_level = [0]


def set_verbosity(level=0, also_to_stdout=False):
    _verbosity[0] = int(level)


def set_code_level(level=100, also_to_stdout=False):
    _code_level[0] = int(level)
