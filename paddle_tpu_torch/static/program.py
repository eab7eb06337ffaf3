"""The program-building API: ``data``, ``InputSpec``, parameters,
``append_backward`` / ``gradients``, the compiled-program and strategy
shells, ``Print``, ``py_func``, ``WeightNormParamAttr`` and the EMA.

Port of ``paddle_tpu/static/program.py``. ``InputSpec``'s dynamic dims
(``-1`` or ``None``) become ``torch.export.Dim``s when a program or a
layer is exported (``inference.export``); a ``data`` variable's meta
value takes 1 for them, as the reference's placeholder does.
"""
import torch

from ..core.dtype import canonical
from ..core.tensor import Tensor
from . import unique_name
from .executor import Executor, global_scope
from .graph import (OpDesc, Variable, VarRef, default_main_program,
                    default_startup_program)

__all__ = ["InputSpec", "data", "create_parameter", "create_global_var",
           "run_startup", "append_backward", "gradients", "CompiledProgram",
           "BuildStrategy", "ExecutionStrategy", "ParallelExecutor", "Print",
           "py_func", "WeightNormParamAttr", "ExponentialMovingAverage"]

# an example size for a dynamic dim: torch.export specialises a dim whose
# example size is 0 or 1 (the reference's placeholder size is 1)
DYNAMIC_EXAMPLE_SIZE = 2


def _dtype(dtype):
    """A dtype name (``"float32"``, ``"bfloat16"``, ``"int64"``, ...) or a
    ``torch.dtype`` as a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("torch.", "")
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return dt


class InputSpec:
    """Shape/dtype/name spec (python/paddle/static/input.py InputSpec)."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = list(shape)
        self.dtype = dtype
        self.name = name

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(list(tensor.shape),
                   str(tensor.dtype).replace("torch.", ""), name)

    def dynamic_dims(self):
        """Indices of the dims that are ``-1`` or ``None``."""
        return [i for i, d in enumerate(self.shape) if d is None or d == -1]

    def example(self, device=None):
        """A zero tensor of this spec on ``device``, each dynamic dim at
        ``DYNAMIC_EXAMPLE_SIZE``: what ``export_layer`` traces with."""
        shape = [DYNAMIC_EXAMPLE_SIZE if (d is None or d == -1) else int(d)
                 for d in self.shape]
        return torch.zeros(shape, dtype=_dtype(self.dtype), device=device)

    def to_meta(self):
        """A meta tensor of this spec, each dynamic dim at 1, in the
        canonical dtype (the reference's ``to_aval``)."""
        shape = [1 if (d is None or d == -1) else int(d) for d in self.shape]
        return torch.empty(shape, dtype=canonical(_dtype(self.dtype)),
                           device="meta")

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


def data(name, shape, dtype="float32", lod_level=0):
    """Declare a feed Variable in the default main program."""
    prog = default_main_program()
    spec = InputSpec(shape, dtype, name)
    v = prog.global_block.create_var(spec.to_meta(), name=name, is_data=True)
    v._input_spec = spec  # the dims as declared (dynamic ones), for export
    if name not in prog._feed_names:
        prog._feed_names.append(name)
    return v


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """A persistable trainable variable. Its value is drawn now, on the
    default place, and its fill op recorded into the startup program
    (``paddle.static.create_parameter``)."""
    from ..nn import initializer as I
    init = default_initializer or (I.Constant(0.0) if is_bias
                                   else I.XavierUniform())
    name = name or unique_name.generate("param")
    raw = init(list(shape), dtype)
    if isinstance(raw, Tensor):
        raw = raw._value
    raw = raw.detach()
    main, startup = default_main_program(), default_startup_program()
    meta = torch.empty(raw.shape, dtype=raw.dtype, device="meta")
    v = main.global_block.create_var(meta, name=name, persistable=True,
                                     trainable=True)
    if name not in main._param_names:
        main._param_names.append(name)
    startup.global_block.append_op(OpDesc(
        "fill_parameter", lambda _v=raw: _v, [], {}, [name], None))
    startup.global_block.vars[name] = Variable(
        meta, name=name, persistable=True, block=startup.global_block)
    startup._version += 1
    return v


def create_global_var(shape, value, dtype="float32", persistable=True,
                      name=None):
    """A variable filled with ``value``, in the scope now."""
    from ..device import default_device
    name = name or unique_name.generate("global_var")
    raw = torch.full(tuple(shape), value,
                     dtype=canonical(_dtype(dtype)), device=default_device())
    main = default_main_program()
    v = main.global_block.create_var(
        torch.empty(raw.shape, dtype=raw.dtype, device="meta"), name=name,
        persistable=persistable)
    global_scope()._vars[name] = raw
    return v


def run_startup(exe=None, startup_program=None):
    """Put the startup program's variables into the scope
    (``Executor.run(startup_program)``). Each value is a copy: the
    Executor updates the scope's tensors in place, and the startup
    program keeps its initial values."""
    prog = startup_program or default_startup_program()
    scope = global_scope()
    for op in prog.global_block.ops:
        out = op.fn()
        for n in op.outputs:
            var = prog.global_block.vars.get(n)
            if var is None or var.persistable:
                dev = exe.device if exe is not None else out.device
                scope._vars[n] = out.detach().to(dev).clone()


def append_backward(loss, parameter_list=None, no_grad_set=None):
    """Request the gradients of ``sum(loss)`` w.r.t. the trainable
    parameters (``parameter_list``'s, less ``no_grad_set``'s); returns
    ``[(param_var, grad_var)]``. The Executor computes them by torch
    autograd over its replay."""
    prog = loss.block.program if getattr(loss, "block", None) is not None \
        else default_main_program()
    block = prog.global_block
    if parameter_list:
        wrt = [p if isinstance(p, str) else p.name for p in parameter_list]
    else:
        wrt = list(prog._param_names)
    if no_grad_set:
        drop = {p if isinstance(p, str) else p.name for p in no_grad_set}
        wrt = [n for n in wrt if n not in drop]
    gnames = [f"{n}@GRAD" for n in wrt]
    for n, g in zip(wrt, gnames):
        src = block.vars[n]
        block.vars[g] = Variable(src._value, name=g, block=block)
    prog._grad_requests.append((loss.name, wrt, gnames))
    prog._version += 1
    return [(block.vars[n], block.vars[g]) for n, g in zip(wrt, gnames)]


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """``paddle.static.gradients``: d(sum(target)) / d(inputs) as new
    variables, for each target."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    t0 = targets[0]
    prog = t0.block.program if getattr(t0, "block", None) is not None \
        else default_main_program()
    block = prog.global_block
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    outs = []
    for t in targets:
        wrt = [v.name for v in inputs]
        gnames = [unique_name.generate(f"{n}@GRAD") for n in wrt]
        for v, g in zip(inputs, gnames):
            block.vars[g] = Variable(v._value, name=g, block=block)
        prog._grad_requests.append((t.name, wrt, gnames))
        outs.extend(block.vars[g] for g in gnames)
    prog._version += 1
    return outs


def _prune_ops(ops, fetch_names):
    """The ops the fetch targets depend on (``Program.prune``, as
    ``save_inference_model`` prunes)."""
    needed = set(fetch_names)
    kept = []
    for op in reversed(ops):
        if any(o in needed for o in op.outputs):
            kept.append(op)
            needed.update(i.name for i in op.inputs if isinstance(i, VarRef))
    return list(reversed(kept))


def _program_infer_fn(program, feed_names, fetch_names, scope):
    """``(fn, scope values)``: ``fn(scope values, *feeds) -> [fetches]``
    over the pruned ops, the function ``inference.export_program``
    exports. A stateful op draws at the time of the call (an export bakes
    one sample): export inference programs."""
    from .executor import _replay
    ops = _prune_ops(program.global_block.ops, fetch_names)
    scope_vals = {}
    for op in ops:
        for i in op.inputs:
            if isinstance(i, VarRef) and i.name in scope._vars:
                scope_vals[i.name] = scope._vars[i.name]

    def fn(values, *feed_vals):
        env = dict(values)
        env.update(zip(feed_names, feed_vals))
        with torch.no_grad():
            _replay(ops, env)
        return [env[n] for n in fetch_names]

    return fn, scope_vals


class CompiledProgram:
    """The reference's shell: the Executor prepares a program once a
    feed signature anyway."""

    def __init__(self, program, build_strategy=None):
        self._program = program

    def __getattr__(self, name):
        return getattr(self._program, name)


class BuildStrategy:
    """Build options, recorded (``apply_build_strategy`` turns
    ``memory_optimize`` and ``fuse_elewise_add_act_ops`` into passes)."""

    def __init__(self):
        self.enable_inplace = True
        self.fuse_elewise_add_act_ops = False
        self.fuse_bn_act_ops = False
        self.memory_optimize = True
        self.reduce_strategy = 0
        self.gradient_scale_strategy = 0
        self.build_cinn_pass = False
        self.enable_addto = False
        self.enable_sequential_execution = False
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 10
        self.num_iteration_per_run = 1
        self.use_thread_barrier = False


class ParallelExecutor:
    """The legacy ParallelExecutor: one Executor over the program."""

    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        self._program = main_program or default_main_program()
        self._exe = Executor()

    def run(self, fetch_list=None, feed=None, feed_dict=None,
            return_numpy=True):
        return self._exe.run(self._program, feed=feed or feed_dict,
                             fetch_list=fetch_list,
                             return_numpy=return_numpy)


def Print(input, first_n=-1, message=None, summarize=20,  # noqa: A002
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    """``static.Print``: prints ``message`` and ``input`` (the reference
    prints while the program is built, through ``convert_print``)."""
    from ..jit.dy2static import convert_print
    convert_print(message or "", input)
    return input


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    from .nn import py_func as _pf
    return _pf(func, x, out, backward_func, skip_vars_in_backward_input)


def WeightNormParamAttr(dim=None, name=None, initializer=None,
                        learning_rate=1.0, regularizer=None,
                        trainable=True, do_model_average=False,
                        need_clip=True):
    """A ``ParamAttr`` carrying the weight norm's ``dim``
    (``weight_norm_dim``); the reparameterization is
    ``nn.utils.weight_norm``'s, at the layer."""
    from ..nn.param_attr import ParamAttr
    attr = ParamAttr(name=name, initializer=initializer,
                     learning_rate=learning_rate, regularizer=regularizer,
                     trainable=trainable, do_model_average=do_model_average,
                     need_clip=need_clip)
    attr.weight_norm_dim = dim
    return attr


def _value_of(p):
    return (p._value if isinstance(p, Tensor) else p).detach()


@torch.no_grad()
def _assign(p, v):
    if isinstance(p, Tensor):
        p.set_value(v)
    else:
        p.copy_(v)


class ExponentialMovingAverage:
    """EMA of parameters: ``update()`` accumulates the shadow weights,
    ``apply()`` swaps them in (a context manager that restores the
    weights on exit unless ``need_restore=False``), ``restore()`` puts
    the weights back."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._shadow = {}
        self._backup = {}

    def update(self, parameters=None):
        params = parameters or _collect_scope_params()
        for p in params:
            key = id(p)
            v = _value_of(p)
            if key not in self._shadow:
                self._shadow[key] = (p, v.clone())
            else:
                _, s = self._shadow[key]
                self._shadow[key] = (p, self._decay * s
                                     + (1 - self._decay) * v)

    def apply(self, executor=None, need_restore=True):
        import contextlib

        @contextlib.contextmanager
        def guard():
            self._backup = {k: _value_of(p).clone()
                            for k, (p, _s) in self._shadow.items()}
            for k, (p, s) in self._shadow.items():
                _assign(p, s)
            try:
                yield
            finally:
                if need_restore:
                    self.restore()

        return guard()

    def restore(self, executor=None):
        for k, (p, _s) in self._shadow.items():
            if k in self._backup:
                _assign(p, self._backup[k])
        self._backup = {}


def _collect_scope_params():
    scope = global_scope()
    return [p for p in scope._params.values() if p is not None]
