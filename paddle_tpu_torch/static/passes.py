"""Static-graph passes: ``PassRegistry``, dead-code elimination,
constant folding, common-subexpression elimination and the annotation
pass, ``apply_pass`` and ``apply_build_strategy``.

Port of ``paddle_tpu/static/passes.py`` (the reference's program-level
cleanups of paddle/fluid/framework/ir). A pass is a function of a
Program that mutates it, registered by name. The port replays programs
eagerly, so a pass shrinks what each ``Executor.run`` executes.
"""
import numpy as np
import torch

from .graph import OpDesc, VarRef, run_op

__all__ = ["PassRegistry", "register_pass", "get_pass", "apply_pass",
           "apply_build_strategy"]


class PassRegistry:
    _passes: dict = {}

    @classmethod
    def register(cls, name, fn):
        cls._passes[name] = fn

    @classmethod
    def get(cls, name):
        if name not in cls._passes:
            raise ValueError(
                f"unknown pass {name!r}; registered: {sorted(cls._passes)}")
        return cls._passes[name]

    @classmethod
    def list(cls):
        return sorted(cls._passes)


def register_pass(name):
    def deco(fn):
        PassRegistry.register(name, fn)
        return fn
    return deco


def get_pass(name):
    return PassRegistry.get(name)


def apply_pass(program, names):
    """paddle.static.apply_pass parity: run the named pass(es) over the
    program's global block, in order."""
    if isinstance(names, str):
        names = [names]
    for n in names:
        PassRegistry.get(n)(program)
        program._version += 1
    return program


def _fetch_roots(program):
    """Names that must stay live: persistables, feeds, declared fetches,
    grad-request outputs. When no fetches were declared
    (normalize_program not called), every unconsumed terminal output is
    a root — pruning would otherwise delete possible fetch targets."""
    roots = set(program._feed_names)
    for name, var in program.global_block.vars.items():
        if getattr(var, "persistable", False):
            roots.add(name)
    for tgt, wrt, gnames in program._grad_requests:
        roots.update(gnames)
        roots.add(tgt)      # the gradient replays the target's producers
        roots.update(wrt)   # Executor.add_grads reads env[w] for each leaf
    fetches = getattr(program, "_normalized_fetches", None)
    if fetches:
        roots.update(fetches)
    else:
        ops = program.global_block.ops
        consumed = {i.name for op in ops for i in op.inputs
                    if isinstance(i, VarRef)}
        for op in ops:
            roots.update(o for o in op.outputs if o not in consumed)
    return roots


@register_pass("dead_code_elimination")
def dead_code_elimination(program):
    """Drop ops none of whose outputs are consumed downstream or rooted
    (reference ir pass: delete_op / graph_to_program pruning)."""
    block = program.global_block
    roots = _fetch_roots(program)
    live = set(roots)
    # walk backwards: an op is live if any output is live
    kept = []
    for op in reversed(block.ops):
        if any(o in live for o in op.outputs) or not op.outputs:
            kept.append(op)
            for i in op.inputs:
                if isinstance(i, VarRef):
                    live.add(i.name)
        # else: dropped
    kept.reverse()
    removed = len(block.ops) - len(kept)
    block.ops = kept
    return removed


@register_pass("constant_folding")
def constant_folding(program):
    """Execute ops whose inputs are all literals at pass time and replace
    them with the computed constant (reference constant_folding_pass)."""
    block = program.global_block
    const_vals = {}
    new_ops = []
    folded = 0
    # grad-wrt leaves act as variables even when their value is constant:
    # an op consuming one must never fold, or the grad target becomes a
    # pass-time constant and the gradient silently zeroes
    wrt_names = {w for _t, wrt, _g in program._grad_requests for w in wrt}
    for op in block.ops:
        ready = []
        all_const = True
        for i in op.inputs:
            if isinstance(i, VarRef):
                if i.name in const_vals and i.name not in wrt_names:
                    ready.append(const_vals[i.name])
                else:
                    all_const = False
                    break
            else:
                ready.append(i)
        # random/stateful ops must not be executed once at pass time and
        # frozen to a single sample (mirrors the CSE guard and the
        # reference constant_folding_pass persistable/stateful skip)
        if all_const and op.outputs and not _stateful(op):
            try:
                with torch.no_grad():
                    flat = run_op(op, ready)
            except Exception:
                new_ops.append(op)
                continue
            for name, val in zip(op.outputs, flat):
                const_vals[name] = val
            folded += 1
        else:
            new_ops.append(op)
    if not const_vals:
        return 0
    # rewrite remaining ops: replace folded VarRefs with literals (keep
    # grad-wrt leaves as VarRefs — the Executor's grad replay injects and
    # protects the leaf value by NAME)
    for op in new_ops:
        op.inputs = [const_vals.get(i.name, i)
                     if isinstance(i, VarRef) and i.name not in wrt_names
                     else i for i in op.inputs]
    # folded names may be fetched (or read as grad leaves): re-emit a
    # constant producer for rooted ones so Executor.run still finds a
    # producing op (same pattern as CSE's share_data identity ops).
    # PREPENDED: consumers that kept a VarRef (wrt leaves) replay later.
    roots = _fetch_roots(program)
    const_ops = [OpDesc("share_data", _identity, [val], {}, [name], None)
                 for name, val in const_vals.items() if name in roots]
    block.ops = const_ops + new_ops
    return folded


def _identity(v):
    return v


def _input_key(i):
    if isinstance(i, VarRef):
        return ("ref", i.name)
    if isinstance(i, (torch.Tensor, np.ndarray)):
        return ("obj", id(i))
    try:
        hash(i)
        return ("lit", i)
    except TypeError:
        return ("obj", id(i))


def _norm_attr(v):
    """Hashable, equality-faithful normal form for attr values: containers
    normalize recursively; ndarrays by exact bytes; other unhashables fall
    back to identity (never merged — safe)."""
    if isinstance(v, (list, tuple)):
        return ("seq", tuple(_norm_attr(e) for e in v))
    if isinstance(v, dict):
        # sort by repr of the key: mixed-type keys are not orderable
        return ("map", tuple(sorted(((repr(k), _norm_attr(x))
                                     for k, x in v.items()))))
    if isinstance(v, np.ndarray):
        return ("nd", v.shape, str(v.dtype), v.tobytes())
    if isinstance(v, torch.Tensor):
        return ("id", id(v))
    try:
        hash(v)
        return ("lit", v)
    except TypeError:
        return ("id", id(v))


@register_pass("common_subexpression_elimination")
def common_subexpression_elimination(program):
    """Merge identical (op_type, inputs, attrs) ops — later duplicates
    reuse the first op's outputs (reference: ir CSE / fuse passes do this
    structurally; here it shrinks what every replay runs)."""
    block = program.global_block
    seen = {}
    alias = {}
    new_ops = []
    merged = 0
    for op in block.ops:
        ins = tuple(_input_key(alias.get(i.name, i)
                               if isinstance(i, VarRef) else i)
                    for i in op.inputs)
        # normalized attrs: hashable AND equality-faithful (repr would
        # collide on truncated ndarray prints; identity fallback never
        # merges distinct unhashable objects)
        key = (op.op_type, ins,
               tuple(sorted((k, _norm_attr(v))
                            for k, v in op.attrs.items())))
        prev = seen.get(key)
        # random/stateful ops must never merge
        if prev is not None and not _stateful(op):
            for mine, theirs in zip(op.outputs, prev.outputs):
                alias[mine] = VarRef(theirs)
            merged += 1
            continue
        seen[key] = op
        new_ops.append(op)
    if alias:
        for op in new_ops:
            op.inputs = [alias.get(i.name, i) if isinstance(i, VarRef)
                         else i for i in op.inputs]
        # aliased names may be fetched: emit identity ops for rooted ones
        roots = _fetch_roots(program)
        for old, ref in alias.items():
            if old in roots:
                new_ops.append(OpDesc("share_data", _identity,
                                      [ref], {}, [old], None))
    block.ops = new_ops
    return merged


_STATEFUL_PREFIXES = ("rand", "uniform", "normal", "dropout", "bernoulli",
                      "poisson", "multinomial", "exponential", "seed",
                      "gumbel", "shuffle", "rrelu")


def _stateful(op):
    t = op.op_type.lower()
    return any(t.startswith(p) or p in t for p in _STATEFUL_PREFIXES)


@register_pass("fuse_elewise_add_act")
def fuse_elewise_add_act(program):
    """Annotation pass (reference fuse_elewise_add_act_pass): tags
    add→activation pairs. Nothing fuses them (the reference leaves that
    to XLA); the tag records the intent and lets tooling count them."""
    block = program.global_block
    producers = {}
    for op in block.ops:
        for o in op.outputs:
            producers[o] = op
    acts = {"relu", "gelu", "sigmoid", "tanh", "silu"}
    tagged = 0
    for op in block.ops:
        if op.op_type in acts and op.inputs:
            i0 = op.inputs[0]
            if isinstance(i0, VarRef):
                p = producers.get(i0.name)
                if p is not None and p.op_type == "add":
                    op.attrs = dict(op.attrs, _fused_with_add=True)
                    tagged += 1
    return tagged


def apply_build_strategy(main_program, startup_program, build_strategy,
                         pass_attrs=None):
    """Reference paddle.static.apply_build_strategy: translate strategy
    flags into pass runs."""
    # DCE is always safe and always beneficial on the recorded program
    names = ["dead_code_elimination"]
    if getattr(build_strategy, "memory_optimize", False):
        names.append("common_subexpression_elimination")
        names.append("constant_folding")
    if getattr(build_strategy, "fuse_elewise_add_act_ops", False):
        names.append("fuse_elewise_add_act")
    return apply_pass(main_program, names)
