"""The threefry2x32 generator and the draws built on it, bit for bit with
``jax.random``.

The JAX package draws every random number from ``jax.random`` under its
defaults at jax 0.9.0: the ``threefry2x32`` PRNG with
``jax_threefry_partitionable=True``. This module is the port's own copy
of the pieces it uses (``jax/_src/prng.py``, ``jax/_src/random.py``),
in plain torch on any device:

- ``threefry2x32``: the 20-round Threefry-2x32 hash (rotations 13 15 26
  6 / 17 29 16 24, key schedule ``k0 ^ k1 ^ 0x1BD11BDA``);
- ``PRNGKey(seed)``: the words ``(0, seed mod 2**32)`` (jax's 32-bit mode
  wraps a Python int to int32 first: negative seeds and seeds past 2**31
  land on the same words);
- ``split`` and ``fold_in``: the hash of the key over the counter
  ``(0, i)``; ``split(key, n)[i] == fold_in(key, i)``;
- ``random_bits``: ``b1 ^ b2`` of the hash over the element's flat index,
  split into its high and low words;
- ``uniform_from_bits`` (f32): the top mantissa bits OR 1.0, minus 1,
  then ``max(minval, fma(u, maxval - minval, minval))`` (XLA contracts
  the scale and shift into one fused multiply-add; ``fma_f32`` emulates
  it); bernoulli is ``uniform < p``;
- ``gumbel_from_bits``: ``-log(-log(uniform(minval, 1)))``, mode "low"
  of ``jax.random.gumbel`` at ``minval = tiny``.

Keys are ``torch.uint32`` tensors whose last dimension holds the two
words, as jax's raw keys are. torch's ``uint32`` has no arithmetic on
the CPU or on CUDA, so the words are carried in int64 masked to 32
bits; the CUDA kernels (``csrc/threefry.cuh``) use ``uint32_t``. Every
function here is a plain version, and the only one: the plain versions
of the card's draws (``ops.kernels.sample_rows``,
``ops.kernels.threefry_fill``) are built from these functions, and the
kernels are held to them.
"""
import math

import numpy as np
import torch

__all__ = ["threefry2x32", "PRNGKey", "key_data", "key_numpy", "make_key",
           "split", "fold_in", "random_bits", "uniform_from_bits",
           "gumbel_from_bits", "log_rn", "fma_f32", "MASK", "TINY_F32"]

MASK = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY_F32 = float(np.finfo(np.float32).tiny)


def _rotl(x, r):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter words ``(x0, x1)`` under the key
    words ``(k0, k1)``, as ``jax._src.prng._threefry2x32_lowering``
    computes it. Words are Python ints or int64 tensors holding values
    in [0, 2**32), broadcast together; returns the two output words in
    the same form."""
    k2 = k0 ^ k1 ^ KS_PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def make_key(w0, w1):
    """A key (``uint32 [..., 2]``) from two int64 word tensors, or from
    two Python ints (a CPU key of shape ``[2]``). Made through an int32
    view: on CUDA torch's uint32 has copies and views only."""
    if isinstance(w0, int):
        w = torch.tensor([w0, w1], dtype=torch.int64)
    else:
        w = torch.stack([w0, w1], -1)
    return (w & MASK).to(torch.int32).view(torch.uint32)


def key_data(key):
    """The two words of ``key`` (``[..., 2]``, uint32 or int64) as int64
    tensors."""
    if key.dtype == torch.uint32:
        key = key.view(torch.int32)
    k = key.to(torch.int64) & MASK
    return k[..., 0], k[..., 1]


def key_numpy(key):
    """``key`` as a numpy ``uint32`` array ``[..., 2]``, the layout of a
    jax key's data (what a checkpoint stores)."""
    w0, w1 = key_data(key.cpu())
    return torch.stack([w0, w1], -1).numpy().astype(np.uint32)


def PRNGKey(seed, device="cpu"):
    """``jax.random.PRNGKey(seed)`` for a Python int: ``(0, seed mod
    2**32)``; for an integer tensor of seeds, one key a seed."""
    if torch.is_tensor(seed):
        lo = seed.to(torch.int64) & MASK
        return make_key(torch.zeros_like(lo), lo)
    return make_key(0, int(seed) & MASK).to(device)


def _hash(key, n):
    """The hash of each key of ``key [..., 2]`` over the flat indices 0
    .. n-1 split into their high and low words: two int64 word tensors
    ``[..., n]``."""
    k0, k1 = key_data(key)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(k0[..., None], k1[..., None], idx >> 32, idx & MASK)


def split(key, num=2):
    """``jax.random.split(key, num)`` of each key of ``key [..., 2]``:
    keys ``[..., *shape, 2]``, key i the hash over the flat index i."""
    shape = tuple(num) if isinstance(num, (tuple, list)) else (int(num),)
    y0, y1 = _hash(key, math.prod(shape))
    return make_key(y0, y1).reshape(key.shape[:-1] + shape + (2,))


def fold_in(key, data):
    """``jax.random.fold_in(key, data)`` of one key ``[2]``: the hash of
    ``key`` over ``(0, data mod 2**32)``, on Python ints (about 20
    microseconds, nothing launched); the new key lies on the CPU."""
    k0, k1 = (int(w) for w in key_data(key))
    return make_key(*threefry2x32(k0, k1, 0, int(data) & MASK))


def random_bits(key, shape):
    """``jax.random.bits(key, shape, uint32)`` under each key of ``key
    [..., 2]``, as int64 values in [0, 2**32) of shape ``[..., *shape]``:
    ``b1 ^ b2`` of the hash over each element's flat index."""
    shape = tuple(shape)
    b0, b1 = _hash(key, math.prod(shape))
    return (b0 ^ b1).reshape(key.shape[:-1] + shape)


def fma_f32(a, b, c):
    """``a * b + c`` rounded once to f32 (a fused multiply-add), for f32
    tensors. The product is exact in f64; the sum is taken in f64 with
    round-to-odd (TwoSum's error word nudges an inexact even result to
    its odd neighbour), which rounds correctly when narrowed to f32."""
    p = a.double() * b.double()
    c = c.double() if torch.is_tensor(c) else torch.tensor(
        c, dtype=torch.float64, device=p.device)
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)
    bits = s.view(torch.int64)
    nudge = (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    s = torch.where(nudge, bits + step, bits).view(torch.float64)
    return s.float()


def uniform_from_bits(bits, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` from
    its 32-bit draws (int64), for Python-number bounds: the top 23 bits
    OR 1.0, minus 1 (exact), then ``max(minval, fma(u, maxval - minval,
    minval))`` with the bounds and their difference in f32. At the
    default bounds it is ``u`` itself, and bernoulli's keep flag is ``u <
    f32(p)``."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) \
        - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    scale = torch.tensor(maxval, dtype=torch.float32, device=f.device) - lo
    return torch.maximum(lo, fma_f32(f, scale, lo))


def gumbel_from_bits(bits, minval=TINY_F32):
    """``-log(-log(uniform(minval, 1)))`` from 32-bit draws: at the
    default ``jax.random.gumbel``'s values (mode "low"), at 1e-10
    ``gumbel_softmax``'s noise. Each log is taken in f64 and rounded to
    f32 (``log_rn``): XLA's f32 log is within one ulp of that, so the
    noise is within two ulps of ``max(|g|, 1)`` of jax's (ROADMAP Queue
    3), not bit for bit."""
    return -log_rn(-log_rn(uniform_from_bits(bits, minval, 1.0)))


def log_rn(x):
    """``log(x)`` rounded once to x's type: taken in f64. torch's f32
    ``log`` on the CPU misses by up to ~1500 ulps near 1; the card's
    ``logf`` by one. The kernels take the same f64 log, so the card's
    Gumbel noise is its plain version's bit for bit."""
    return torch.log(x.double()).to(x.dtype)
