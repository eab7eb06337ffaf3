"""Global RNG state and scoped keys, on the threefry stream of
``jax.random``.

Port of ``paddle_tpu/core/random.py``: one root key (``PRNGKey(seed)``)
plus a fold-in counter gives each eager random op a fresh, reproducible
subkey; ``rng_scope(key)`` routes ops to subkeys of an explicit key
instead, innermost scope first. The same seed gives the same keys as
the reference, op for op (``prng`` is bit for bit with
``jax.random``). State is per thread, as in the reference.

Keys are ``torch.uint32`` tensors ``[2]`` on the CPU; the fold-in runs
on Python ints (``prng.fold_in``), so drawing a key never touches the
card.
"""
import contextlib
import threading

import numpy as np
import torch

from . import prng

__all__ = ["seed", "get_rng_state", "set_rng_state", "rng_scope",
           "next_key", "in_rng_scope"]

_state = threading.local()


def _tls():
    if not hasattr(_state, "key"):
        _state.key = prng.PRNGKey(0)
        _state.count = 0
        _state.scopes = []
    return _state


def seed(s):
    """Reset the root key to ``PRNGKey(s)`` and the counter to 0; returns
    the key."""
    tls = _tls()
    tls.key = prng.PRNGKey(int(s))
    tls.count = 0
    return tls.key


def get_rng_state():
    """``(key, count)``: the root key and how many keys it has given."""
    tls = _tls()
    return (tls.key, tls.count)


def _as_key(key):
    """A key given as a tensor or an array (a jax key too) as a CPU
    ``uint32 [2]`` tensor."""
    if torch.is_tensor(key):
        return prng.make_key(*(int(w) for w in key.cpu().tolist()))
    return prng.make_key(*(int(w) for w in np.asarray(key).tolist()))


def set_rng_state(state):
    """Restore a ``get_rng_state()``: the root key and its counter."""
    tls = _tls()
    key, count = state
    tls.key = _as_key(key)
    tls.count = int(count)


class _Scope:
    __slots__ = ("key", "count")

    def __init__(self, key):
        self.key = key
        self.count = 0


@contextlib.contextmanager
def rng_scope(key):
    """Route random ops to subkeys of ``key`` (``fold_in(key, 0)``,
    ``fold_in(key, 1)``, ...) while the scope is open."""
    tls = _tls()
    tls.scopes.append(_Scope(_as_key(key)))
    try:
        yield
    finally:
        tls.scopes.pop()


def next_key():
    """A fresh subkey: from the innermost scope if one is open, else from
    the global state."""
    tls = _tls()
    holder = tls.scopes[-1] if tls.scopes else tls
    k = prng.fold_in(holder.key, holder.count)
    holder.count += 1
    return k


def in_rng_scope():
    return bool(_tls().scopes)
