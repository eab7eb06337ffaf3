"""Static-graph execution: ``Scope`` and ``Executor`` over Programs
replayed eagerly.

Port of ``paddle_tpu/static/executor.py``. The reference replays the
recorded op list inside one ``jax.jit`` (forward, gradients and the
optimizer's update one XLA program); the port replays it eagerly, op by
op, so every op runs what the eager API runs: K4, K5 and K6 on the card
through their wrappers, R2's draws, cuBLAS. Gradients are torch
autograd over the replay (``torch.autograd.grad``), the update the
optimizer's ``functional()`` one, in place on the scope's tensors.
``Executor._cache`` keeps a prepared plan per (program, version, feed
signature, fetch list), as the reference keeps its compiled programs.

Random ops draw per run: each stateful op (``passes._stateful``)
replays inside ``rng_scope(fold_in(run_key, op index))``, ``run_key``
being ``PRNGKey(program.random_seed)`` when the seed is set, else the
global generator's ``next_key()``; a program with no stateful op never
touches the generator (``_zero_key``). The forward and the gradient
replays of one run see the same masks.
"""
import contextlib
import weakref

import numpy as np
import torch

from ..core import prng
from ..core.tensor import Tensor, as_value
from ..device import default_device, place_to_device
from .graph import Variable, VarRef, default_main_program, run_op

__all__ = ["Scope", "Executor", "global_scope", "scope_guard"]


class _VarHolder:
    def __init__(self, scope, name):
        self._scope = scope
        self._name = name

    def get_tensor(self):
        v = self._scope._vars[self._name]
        return Tensor(v).numpy() if torch.is_tensor(v) else np.asarray(v)

    def set(self, value, place=None):
        self._scope._vars[self._name] = as_value(
            value, device=place_to_device(place))


class Scope:
    """Name -> value store of the persistable variables."""

    def __init__(self):
        self._vars = {}     # name -> torch tensor (or an array set by hand)
        self._params = {}   # name -> the eager parameter it was interned from

    def var(self, name):
        return _VarHolder(self, name)

    def find_var(self, name):
        return _VarHolder(self, name) if name in self._vars else None

    def local_var_names(self):
        return list(self._vars)

    def drop_kids(self):
        pass


_global_scope = Scope()
_scope_stack = [_global_scope]


def _zero_key():
    """The run key of a program without a stateful op: never drawn from
    the generator, never read by an op."""
    return prng.PRNGKey(0)


def global_scope():
    return _scope_stack[-1]


@contextlib.contextmanager
def scope_guard(scope):
    _scope_stack.append(scope)
    try:
        yield
    finally:
        _scope_stack.pop()


def _replay(ops, env, protect=frozenset(), run_key=None):
    """Replay ``ops`` into ``env``. Names in ``protect`` are gradient
    leaves: their injected values are never overwritten, and an op is
    skipped only when ALL its outputs are protected (one with a sibling
    output still runs). With ``run_key`` each stateful op draws under
    ``fold_in(run_key, its index)``."""
    from ..core import random as rnd
    from .passes import _stateful
    for idx, op in enumerate(ops):
        outs = set(op.outputs)
        if outs and outs <= protect:
            continue
        vals = [env[i.name] if isinstance(i, VarRef) else i
                for i in op.inputs]
        if run_key is not None and _stateful(op):
            with rnd.rng_scope(prng.fold_in(run_key, idx)):
                flat = run_op(op, vals)
        else:
            flat = run_op(op, vals)
        for n, v in zip(op.outputs, flat):
            if n not in protect:
                env[n] = v
    return env


def _referenced_scope_names(program, scope):
    names = []
    for op in program.global_block.ops:
        for i in op.inputs:
            if isinstance(i, VarRef) and i.name in scope._vars \
                    and i.name not in names:
                names.append(i.name)
    return names


def _leaf(v):
    """A gradient leaf over ``v``'s storage (floating types only)."""
    v = v.detach()
    if v.is_floating_point() or v.is_complex():
        v.requires_grad_(True)
    return v


def _grads(target, leaves):
    """d(sum(target)) / d(leaves), zeros where it does not depend on a
    leaf (as ``jax.grad`` gives)."""
    diff = [i for i, l in enumerate(leaves) if l.requires_grad]
    out = [torch.zeros_like(l) for l in leaves]
    t = target.sum()
    if diff and t.requires_grad:
        gs = torch.autograd.grad(t, [leaves[i] for i in diff],
                                 allow_unused=True)
        for i, g in zip(diff, gs):
            if g is not None:
                out[i] = g
    return out


def _storage(t):
    return t.untyped_storage().data_ptr()


class Executor:
    """``paddle.static.Executor``: runs Programs on ``place`` (None: the
    default place, the card unless ``set_device`` chose another)."""

    def __init__(self, place=None):
        self.place = place
        self._cache = {}
        # program -> (optimizer state, steps); gone with the program
        self._opt_states = weakref.WeakKeyDictionary()

    def close(self):
        self._cache.clear()

    @property
    def device(self):
        dev = place_to_device(self.place)
        return default_device() if dev is None else dev

    # ------------------------------------------------------------------
    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy=True, scope=None, **kwargs):
        program = program or default_main_program()
        if (not fetch_list and not feed and program._train_spec is None
                and any(op.op_type == "fill_parameter"
                        for op in program.global_block.ops)):
            from .program import run_startup    # a startup program
            run_startup(self, program)
            return []
        feed = feed or {}
        fetch_list = fetch_list or []
        scope = scope or global_scope()
        dev = self.device

        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in fetch_list]
        feed_names = sorted(feed.keys())
        feed_vals = [as_value(feed[n], device=dev) for n in feed_names]
        feed_sig = tuple((n, tuple(v.shape), str(v.dtype))
                         for n, v in zip(feed_names, feed_vals))

        key = (id(program), program._version, feed_sig, tuple(fetch_names))
        entry = self._cache.get(key)
        if entry is None:
            entry = self._prepare(program, scope, feed_names, fetch_names)
            self._cache[key] = entry
        # the entry holds the Program, so its id cannot be reused by a
        # new Program while the entry lives
        fn, scope_in_names, train, has_stateful, _prog = entry

        scope_vals = {n: self._scope_value(scope, n, dev)
                      for n in scope_in_names}
        from ..core import random as rnd
        if not has_stateful:
            run_key = _zero_key()
        elif getattr(program, "random_seed", 0):
            run_key = prng.PRNGKey(int(program.random_seed))
        else:
            run_key = rnd.next_key()
        if train:
            opt, _loss, pnames = program._train_spec
            st = self._opt_states.get(program)
            if st is None:
                init_fn, _ = opt.functional()
                st = (init_fn({n: scope_vals[n] for n in pnames}), 0)
            opt_state, step_count = st
            fetches, new_persist = fn(feed_vals, scope_vals, opt_state,
                                      step_count + 1, float(opt.get_lr()),
                                      run_key)
            self._opt_states[program] = (opt_state, step_count + 1)
            from ..optimizer.lr import LRScheduler
            if isinstance(opt._lr, LRScheduler):
                opt._lr.step()
        else:
            fetches, new_persist = fn(feed_vals, scope_vals, run_key)

        for n, v in new_persist.items():
            if scope._vars.get(n) is not v:
                scope._vars[n] = v
            p = scope._params.get(n)
            if p is not None:
                _write_back(p, v)
        if return_numpy:
            fetches = [Tensor(v).numpy() for v in fetches]
        return fetches

    @staticmethod
    def _scope_value(scope, name, dev):
        """The scope's value of ``name`` as a tensor on ``dev`` (a value
        set by hand as an array, or held elsewhere, is moved there and
        kept)."""
        v = scope._vars[name]
        if not (torch.is_tensor(v) and v.device == dev) \
                or (torch.is_tensor(v) and v.requires_grad):
            v = as_value(v, device=dev)
            scope._vars[name] = v
        return v

    # ------------------------------------------------------------------
    def _prepare(self, program, scope, feed_names, fetch_names):
        ops = list(program.global_block.ops)
        from .passes import _stateful
        has_stateful = any(_stateful(op) for op in ops)
        block_vars = program.global_block.vars
        scope_in_names = _referenced_scope_names(program, scope)
        persist_out = [n for n in block_vars
                       if block_vars[n].persistable and n in scope._vars]
        train = program._train_spec is not None
        grad_requests = list(program._grad_requests)

        needed_grads = set()
        for tgt, wrt, gnames in grad_requests:
            if any(g in fetch_names for g in gnames):
                needed_grads.update(gnames)

        def build_env(feed_vals, scope_vals):
            env = dict(scope_vals)
            env.update(zip(feed_names, feed_vals))
            return env

        def add_grads(env, run_key):
            for tgt, wrt, gnames in grad_requests:
                if not any(g in needed_grads for g in gnames):
                    continue
                e = dict(env)
                leaves = [_leaf(env[n]) for n in wrt]
                e.update(zip(wrt, leaves))
                # the wrt vars are leaves: their injected values are
                # protected (else a gradient w.r.t. an intermediate is
                # 0), while ops that also give non-wrt siblings run
                with torch.enable_grad():
                    _replay(ops, e, protect=frozenset(wrt), run_key=run_key)
                    gs = _grads(e[tgt], leaves)
                for g, gname in zip(gs, gnames):
                    env[gname] = g

        if not train:
            def fn(feed_vals, scope_vals, run_key):
                env = build_env(feed_vals, scope_vals)
                with torch.no_grad():
                    _replay(ops, env, run_key=run_key)
                add_grads(env, run_key)
                fetches = [env[n] for n in fetch_names]
                # a persistable var no op references never enters env
                new_persist = {n: env[n] for n in persist_out if n in env}
                return fetches, new_persist

            return fn, scope_in_names, False, has_stateful, program

        opt, loss_name, pnames = program._train_spec
        pnames = list(pnames)

        def train_fn(feed_vals, scope_vals, opt_state, step_i, lr, run_key):
            env = build_env(feed_vals, scope_vals)
            leaves = [_leaf(env[n]) for n in pnames]
            e = dict(env)
            e.update(zip(pnames, leaves))
            with torch.enable_grad():
                _replay(ops, e, run_key=run_key)
                gs = _grads(e[loss_name], leaves)
            grads = dict(zip(pnames, gs))
            if opt._grad_clip is not None:
                from ..nn.clip import clip_by_global_norm_tree
                grads, _ = clip_by_global_norm_tree(
                    grads, opt._grad_clip.clip_norm)
            for tgt, wrt, gnames in grad_requests:
                for w, gname in zip(wrt, gnames):
                    if w in grads:
                        e[gname] = grads[w]
            # the update is in place on the scope's tensors: a fetched
            # intermediate that views a parameter is copied first
            pvals = {n: env[n] for n in pnames}
            held = {_storage(v) for v in pvals.values()}
            snap = {}
            for n in fetch_names:
                v = e[n].detach()
                if n not in pvals and _storage(v) in held:
                    v = v.clone()
                snap[n] = v
            _, update_fn = opt.functional()
            update_fn(grads, pvals, opt_state, lr=lr, step=step_i,
                      weak_lr=False)
            snap.update({n: pvals[n] for n in fetch_names if n in pvals})
            e.update(pvals)
            fetches = [snap[n] for n in fetch_names]
            new_persist = {n: e[n] for n in persist_out if n in e}
            return fetches, new_persist

        return train_fn, scope_in_names, True, has_stateful, program


@torch.no_grad()
def _write_back(param, value):
    """Give an eager parameter interned into the scope the scope's value
    (nothing to do where the scope holds an alias of its storage)."""
    cur = param._value if isinstance(param, Tensor) else param
    if cur.device == value.device and _storage(cur) == _storage(value):
        return
    if isinstance(param, Tensor):
        param.set_value(value)
    else:
        param.copy_(value)
