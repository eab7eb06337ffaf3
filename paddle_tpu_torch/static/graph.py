"""The static graph's IR: ``Program``, ``Variable`` and ``OpDesc``, built
by intercepting ops.

Port of ``paddle_tpu/static/graph.py``. A ``Program`` records the exact
functions of torch tensors that the eager ops would run (``dispatch``'s
``fn``), each with its inputs (``VarRef``s to named variables, or
literals) and keyword attributes; ``static.Executor`` replays the list
eagerly (``executor.py``). While a ``program_guard`` (or
``enable_static_mode``) is open, ``core.tensor.dispatch`` hands every op
that touches a symbolic ``Variable`` to ``_Recorder.record`` instead of
running it, and ``nn.Layer.__call__`` hands it a layer called on one
(``record_layer``: the whole layer one op over its parameters).

Shapes are inferred on torch's meta device, where the reference uses
``jax.eval_shape``: a ``Variable``'s value is a meta tensor (shape and
dtype, no storage), and recording an op runs ``fn`` once on meta copies
of its inputs. A meta tensor holds no values, so inferring a kernel
op's shape launches nothing and computes nothing on the card: the
kernel wrappers (K4, K5, K6, R2) see a tensor that is not on the card
and trace only their plain version's shapes. A random op draws its key
inside ``fn``, so inference advances the global generator once an op,
as the reference's ``eval_shape`` does.

A Python argument given by position stays a Python value in the op's
inputs (``pt.reshape(x, [..])``, ``pt.unsqueeze(x, 0)``): the
reference's Executor traces such a value inside its ``jax.jit`` and
fails (ROADMAP, Queue 3).
"""
import contextlib
import copy

import numpy as np
import torch
from torch.utils import _pytree

from ..core.tensor import (Parameter, Tensor, _canon_out, as_value,
                           set_static_recorder)
from . import unique_name

__all__ = ["Variable", "VarRef", "OpDesc", "Block", "Program",
           "op_call_kwargs", "run_op", "default_main_program",
           "default_startup_program", "program_guard", "in_static_build",
           "enable_static_mode", "disable_static_mode", "in_static_mode"]


def meta_like(v):
    """A meta tensor of ``v``'s shape and dtype."""
    return torch.empty(tuple(v.shape), dtype=v.dtype, device="meta")


class Variable(Tensor):
    """A symbolic tensor of a Program (the VarDesc). ``_value`` is a meta
    tensor, so ``shape``, ``dtype`` and the Tensor methods (which go
    through ``dispatch`` and are recorded) work on it."""

    def __init__(self, meta, name=None, persistable=False, trainable=False,
                 is_data=False, block=None):
        self._value = meta
        self._hooks = None
        self._hook_handle = None
        self.name = name or unique_name.generate("tmp_var")
        self.persistable = persistable
        self.trainable = trainable
        self.is_data = is_data
        self.block = block
        self._sg = not trainable

    @property
    def desc(self):
        return self

    def numpy(self):
        value = _find_scope_value(self.name)
        if value is not None:
            if torch.is_tensor(value):
                return Tensor(value).numpy()
            return np.asarray(value)
        raise RuntimeError(
            f"Variable {self.name!r} is symbolic; run the program through a "
            "static.Executor and fetch it instead of calling .numpy()")

    def __bool__(self):
        raise TypeError(
            f"Variable {self.name!r} is symbolic and has no truth value; "
            "use static.nn.cond / while_loop for control flow on it")

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={list(self._value.shape)}"
                f", dtype={str(self._value.dtype).replace('torch.', '')}, "
                f"persistable={self.persistable})")


def _find_scope_value(name):
    from .executor import global_scope
    return global_scope()._vars.get(name)


class VarRef:
    """A reference to a named variable of the environment (vs a
    literal)."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return f"VarRef({self.name})"


class OpDesc:
    """One recorded op: a function of torch tensors, its input refs and
    literals, its keyword attributes and its output names (the tensor
    leaves of its output, in order). ``out_treedef`` is ``(tree spec,
    [leaf is a tensor])`` of the output the recording saw."""

    __slots__ = ("op_type", "fn", "inputs", "attrs", "outputs", "out_treedef")

    def __init__(self, op_type, fn, inputs, attrs, outputs, out_treedef):
        self.op_type = op_type
        self.fn = fn
        self.inputs = inputs      # [VarRef | literal]
        self.attrs = attrs        # keyword arguments (static attributes)
        self.outputs = outputs    # output variable names
        self.out_treedef = out_treedef

    def __repr__(self):
        ins = [i.name if isinstance(i, VarRef) else type(i).__name__
               for i in self.inputs]
        return f"{{Op({self.op_type}) inputs={ins} outputs={self.outputs}}}"


def op_call_kwargs(op):
    """An op's keyword arguments: attributes whose name starts with ``_``
    are the passes' annotations (``passes.py``), never arguments."""
    return {k: v for k, v in op.attrs.items() if not k.startswith("_")}


def _device_of(vals):
    for v in vals:
        if torch.is_tensor(v):
            return v.device
    return None


def run_op(op, vals):
    """``op.fn(*vals, **attrs)`` as ``dispatch`` runs it: numpy literals
    become tensors on the first tensor's device, outputs take the
    canonical dtypes. Returns the output's tensor leaves, in order."""
    if any(isinstance(v, np.ndarray) for v in vals):
        dev = _device_of(vals)
        vals = [as_value(v, device=dev) if isinstance(v, np.ndarray) else v
                for v in vals]
    out = _canon_out(op.fn(*vals, **op_call_kwargs(op)))
    return [x for x in _pytree.tree_leaves(out) if torch.is_tensor(x)]


class Block:
    def __init__(self, program, idx=0):
        self.program = program
        self.idx = idx
        self.ops = []
        self.vars = {}

    def var(self, name):
        if name not in self.vars:
            raise ValueError(f"var {name} not in block {self.idx}")
        return self.vars[name]

    def create_var(self, meta, name=None, **kwargs):
        v = Variable(meta, name=name, block=self, **kwargs)
        self.vars[v.name] = v
        return v

    def append_op(self, op):
        self.ops.append(op)


class Program:
    """The ProgramDesc: a block of recorded ops and the feed, parameter,
    gradient and training metadata."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.random_seed = 0
        self._feed_names = []       # data vars, in declaration order
        self._param_names = []      # persistable trainable vars
        self._grad_requests = []    # (target, [wrt names], [grad names])
        self._train_spec = None     # (optimizer, loss name, [param names])
        self._version = 0

    @property
    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[0]

    def all_parameters(self):
        return [self.global_block.vars[n] for n in self._param_names]

    def list_vars(self):
        return list(self.global_block.vars.values())

    @property
    def num_ops(self):
        return len(self.global_block.ops)

    def clone(self, for_test=False):
        """A program over the same ops and variables; ``for_test`` drops
        the gradient requests and the training spec."""
        p = Program()
        p.blocks[0].ops = list(self.global_block.ops)
        p.blocks[0].vars = dict(self.global_block.vars)
        p._feed_names = list(self._feed_names)
        p._param_names = list(self._param_names)
        p._grad_requests = [] if for_test else copy.copy(self._grad_requests)
        p._train_spec = None if for_test else self._train_spec
        p.random_seed = self.random_seed
        return p

    def __str__(self):
        lines = [f"Program(ops={self.num_ops}, feeds={self._feed_names}, "
                 f"params={self._param_names})"]
        for op in self.global_block.ops:
            lines.append("  " + repr(op))
        return "\n".join(lines)

    __repr__ = __str__


_default_main = Program()
_default_startup = Program()
_guard_depth = 0
_static_mode = False


def default_main_program():
    return _default_main


def default_startup_program():
    return _default_startup


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    """Record ops on Variables into ``main_program`` (parameters' init ops
    into ``startup_program``) while the block is open."""
    global _default_main, _default_startup, _guard_depth
    old_main, old_startup = _default_main, _default_startup
    _default_main = main_program
    if startup_program is not None:
        _default_startup = startup_program
    _guard_depth += 1
    set_static_recorder(_recorder)
    try:
        yield
    finally:
        _guard_depth -= 1
        _default_main, _default_startup = old_main, old_startup
        if _guard_depth == 0:
            set_static_recorder(None)


def in_static_build():
    return _guard_depth > 0


def enable_static_mode():
    """Global static mode (``paddle.enable_static``): ops on Variables
    record into ``default_main_program()`` without a ``program_guard``."""
    global _guard_depth, _static_mode
    if not _static_mode:
        _static_mode = True
        _guard_depth += 1
        set_static_recorder(_recorder)


def disable_static_mode():
    """``paddle.disable_static``; nothing when static mode is off."""
    global _guard_depth, _static_mode
    if _static_mode:
        _static_mode = False
        _guard_depth -= 1
        if _guard_depth == 0:
            set_static_recorder(None)


def in_static_mode():
    return _static_mode


def _is_param(a):
    return isinstance(a, (Parameter, torch.nn.Parameter))


def _symbolic(a):
    if isinstance(a, Variable):
        return True
    if isinstance(a, (list, tuple)):
        return any(isinstance(x, Variable) for x in a)
    return False


class _Recorder:
    """``dispatch``'s hook: records the ops that touch Variables."""

    def active(self, args, kwargs=None):
        if _guard_depth == 0:
            return False
        if any(isinstance(a, Variable) for a in args):
            return True
        return bool(kwargs) and any(_symbolic(a) for a in kwargs.values())

    def record(self, fn, args, kwargs, name=None, nondiff_args=()):
        block = _default_main.global_block
        kw_vars = [k for k, a in kwargs.items() if isinstance(a, Tensor)
                   or _is_param(a)]
        if kw_vars:
            # tensors given by keyword become inputs of the recorded op
            n = len(args)
            static_kw = {k: a for k, a in kwargs.items() if k not in kw_vars}
            base = fn

            def fn(*vals, _base=base, _n=n, _names=tuple(kw_vars), **kw):
                return _base(*vals[:_n], **kw,
                             **dict(zip(_names, vals[_n:])))

            fn.__name__ = getattr(base, "__name__", "op")
            args = tuple(args) + tuple(kwargs[k] for k in kw_vars)
            kwargs = static_kw
        inputs, metas = [], []
        for a in args:
            if isinstance(a, Variable):
                inputs.append(VarRef(a.name))
                metas.append(a._value)
            elif _is_param(a):
                inputs.append(_intern_parameter(a, block))
                metas.append(meta_like(a._value if isinstance(a, Tensor)
                                       else a))
            elif isinstance(a, Tensor) or torch.is_tensor(a):
                v = (a._value if isinstance(a, Tensor) else a).detach()
                inputs.append(v)
                metas.append(meta_like(v))
            elif isinstance(a, np.ndarray):
                inputs.append(a)
                metas.append(meta_like(as_value(a, device="cpu")))
            else:
                inputs.append(a)
                metas.append(a)
        op_type = name or getattr(fn, "__name__", "op")
        op = OpDesc(op_type, fn, inputs, dict(kwargs), [], None)
        with torch.no_grad():
            out = _canon_out(fn(*metas, **kwargs))
        leaves, spec = _pytree.tree_flatten(out)
        is_var = [torch.is_tensor(x) for x in leaves]
        outs = []
        for x, v in zip(leaves, is_var):
            if v:
                var = block.create_var(meta_like(x),
                                       name=unique_name.generate(op_type))
                op.outputs.append(var.name)
                outs.append(var)
            else:
                outs.append(x)
        op.out_treedef = (spec, is_var)
        block.append_op(op)
        _default_main._version += 1
        return _pytree.tree_unflatten(outs, spec)

    def record_layer(self, layer, inputs, kwargs):
        """A ``nn.Layer`` called on Variables: one op over the layer's
        parameters (interned as persistable variables, so ``minimize``
        trains them and the layer sees the new values) and its inputs,
        running ``forward`` through ``torch.func.functional_call``."""
        named = [(n, p) for n, p in layer.named_parameters()]
        local = tuple(n for n, _ in named)
        n_p = len(named)
        kw = dict(kwargs)

        def layer_fn(*vals):
            from ..nn.layer import _unwrap_tree
            params = dict(zip(local, vals[:n_p]))
            out = torch.func.functional_call(
                layer, params, tuple(vals[n_p:]), _unwrap_tree(kw))
            return out

        layer_fn.__name__ = type(layer).__name__.lower()
        return self.record(layer_fn, [p for _, p in named] + list(inputs),
                           {}, name=layer_fn.__name__)


def _intern_parameter(param, block):
    """A concrete parameter used while a program is built becomes a
    persistable scope variable, so a dygraph layer works under
    ``program_guard`` and ``minimize`` finds and updates its weights.
    The scope holds a detached alias of the parameter's storage: the
    Executor's in-place update reaches the parameter itself."""
    from .executor import global_scope
    pname = getattr(param, "name", None) or unique_name.generate("param")
    param.name = pname
    prog = _default_main
    if pname not in block.vars:
        value = param._value if isinstance(param, Tensor) else param
        trainable = (not param.stop_gradient) if isinstance(param, Tensor) \
            else param.requires_grad
        v = Variable(meta_like(value), name=pname, persistable=True,
                     trainable=trainable, block=block)
        block.vars[pname] = v
        if v.trainable and pname not in prog._param_names:
            prog._param_names.append(pname)
        global_scope()._vars[pname] = value.detach()
        global_scope()._params[pname] = param
    return VarRef(pname)


_recorder = _Recorder()
