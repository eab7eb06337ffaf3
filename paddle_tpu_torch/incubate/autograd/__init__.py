"""paddle.incubate.autograd parity: the functional transforms.

Port of ``paddle_tpu/incubate/autograd/__init__.py``: ``vjp`` / ``jvp``
/ ``Jacobian`` / ``Hessian`` are the port's ``autograd``;
``forward_grad`` appends a forward-mode op to a static ``Program`` that
replays the recorded subgraph from the inputs to the outputs under
``torch.func.jvp`` when the program runs; the primitive switches are
kept for parity (every op here is already torch's own primitive).
"""
import numpy as np
import torch

from ...autograd import hessian, jacobian, jvp, vjp  # noqa: F401

__all__ = ["vjp", "jvp", "Jacobian", "Hessian", "jacobian", "hessian",
           "forward_grad", "grad", "enable_prim", "disable_prim",
           "prim_enabled", "to_prim"]

Jacobian = jacobian
Hessian = hessian


def _slice(block, out_names, wrt):
    """The ops of ``block`` that the outputs depend on, in order, and the
    names they read that none of them makes and that are not in
    ``wrt``."""
    from ...static.graph import VarRef
    needed = set(out_names)
    ops = []
    for op in reversed(list(block.ops)):
        if any(o in needed for o in op.outputs):
            ops.append(op)
            needed.update(i.name for i in op.inputs
                          if isinstance(i, VarRef))
    ops.reverse()
    produced = {n for op in ops for n in op.outputs}
    ext = []
    for op in ops:
        for i in op.inputs:
            if isinstance(i, VarRef) and i.name not in produced \
                    and i.name not in ext and i.name not in wrt:
                ext.append(i.name)
    return ops, ext


def forward_grad(outputs, inputs, grad_inputs=None):
    """Forward-mode gradients of static ``Variable``s: appends one op to
    the outputs' ``Program`` that replays the recorded ops from
    ``inputs`` to ``outputs`` under ``torch.func.jvp`` and returns new
    Variables holding the tangents (one per output; a lone output gives
    a lone Variable). ``grad_inputs`` are the input tangents (Variables,
    tensors or arrays); by default ones, made when the program runs, so
    a dynamic (-1) feed dim works. For eager tensors use ``autograd.jvp``.
    """
    from ...static.executor import _replay
    from ...static.graph import OpDesc, VarRef, Variable
    from ...static.unique_name import generate

    outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if not all(isinstance(v, Variable) for v in list(outs) + list(ins)):
        raise TypeError(
            "forward_grad expects static Variables; for eager tensors "
            "use paddle_tpu_torch.autograd.jvp")
    prog = outs[0].block.program
    block = prog.global_block
    wrt = [v.name for v in ins]
    out_names = [v.name for v in outs]
    ops, ext = _slice(block, out_names, wrt)
    if grad_inputs is None:
        tangents = []
    else:
        gi = grad_inputs if isinstance(grad_inputs, (list, tuple)) \
            else [grad_inputs]
        # Variables become graph inputs; concrete values literals
        tangents = [VarRef(t.name) if isinstance(t, Variable)
                    else np.asarray(t.numpy() if hasattr(t, "numpy")
                                    else t) for t in gi]
    n_tg = len(tangents)

    def fn(*vals):
        n_ext = len(ext)
        ext_vals = vals[:n_ext]
        wrt_vals = vals[n_ext:n_ext + len(wrt)]
        tg = vals[n_ext + len(wrt):]
        if not n_tg:
            tg = tuple(torch.ones_like(v) for v in wrt_vals)
        tg = tuple(t.to(v.dtype) for t, v in zip(tg, wrt_vals))

        def f(wv):
            env = dict(zip(ext, ext_vals))
            env.update(zip(wrt, wv))
            _replay(ops, env, protect=frozenset(wrt))
            return tuple(env[n] for n in out_names)

        _, tangent_out = torch.func.jvp(f, (tuple(wrt_vals),), (tg,))
        return tangent_out

    new_vars = []
    for v in outs:
        nv = Variable(v._value, name=generate(f"{v.name}@FJVP"),
                      block=block)
        block.vars[nv.name] = nv
        new_vars.append(nv)
    block.append_op(OpDesc(
        "forward_grad", fn,
        [VarRef(n) for n in ext] + [VarRef(n) for n in wrt]
        + list(tangents),
        {}, [nv.name for nv in new_vars], None))
    prog._version += 1
    return new_vars if isinstance(outputs, (list, tuple)) else new_vars[0]


def grad(outputs, inputs, grad_outputs=None):
    from ...autograd import grad as _grad
    return _grad(outputs, inputs, grad_outputs)


_prim_enabled = [False]


def enable_prim():
    """Switch primitive-op AD on (kept for parity; every op of the port
    is already differentiated by torch's own rules)."""
    _prim_enabled[0] = True


def disable_prim():
    _prim_enabled[0] = False


def prim_enabled():
    return _prim_enabled[0]


def to_prim(blocks=None):
    """Lower a static block to primitive ops: the recorded programs
    already run torch's primitives, so this is the identity."""
    return blocks
