"""Random sampling ops over the global or scoped RNG (paddle.rand, randn,
...): port of ``paddle_tpu/ops/random_ops.py``.

Each op takes its key from ``core.random.next_key`` exactly where the
reference does, so the same ``seed()`` consumes the same keys and draws
``jax.random``'s values (``core.prng``): the uniform family, ``randint``,
``randperm``, ``shuffle`` and ``bernoulli`` bit for bit, the normal
family within 3 ulps of XLA's ``erf_inv`` (ROADMAP Queue 3), the Gumbel
noise of ``multinomial`` and the logs of ``poisson`` and
``exponential_`` within 2 ulps of XLA's logs. jax's algorithms over the
draws (randint's modular fold, the shuffle's sorting rounds,
categorical, poisson's Knuth and rejection loops) are here, over
``core.prng``'s keys. The element-wise draws are R2
(``ops.kernels.threefry_fill``): the kernel on the card, its plain
version on the CPU. A new tensor goes to the default place (the card
unless ``set_device`` said otherwise; without a card it raises); an op
over a tensor keeps that tensor's device. Floating draws are f32 or bf16
(jax's 16-bit rule for bf16); integer results are int32, as the
reference's with x64 off.
"""
import numpy as np
import torch

from ..core import prng
from ..core import random as rnd
from ..core.dtype import canonical, convert_dtype
from ..core.tensor import Tensor, unwrap, wrap
from ..device import default_device
from .kernels import threefry_fill as _tf
from .registry import register_direct

__all__ = ["rand", "randn", "uniform", "normal", "gaussian", "randint",
           "randint_like", "randperm", "shuffle", "multinomial", "bernoulli",
           "poisson", "exponential_", "standard_normal", "rand_like",
           "randn_like"]


# -- jax's algorithms over the draws (jax 0.9.0's ``jax/_src/random.py``),
#    each draw through R2: the kernel for a CUDA device, its plain version
#    on the CPU.

def _split2(key):
    ks = prng.split(key, 2)
    return ks[0], ks[1]


def _randint(key, shape, low, high, device):
    """``jax.random.randint(key, shape, low, high, int32)`` for Python
    ints: two 32-bit draws under ``split(key)`` folded into the span
    with jax's modular arithmetic on uint32 (wrapping products), as
    int32."""
    mask = prng.MASK
    i32 = np.iinfo(np.int32)
    out_of_range = high > i32.max
    lo = min(max(int(low), i32.min), i32.max)
    hi = min(max(int(high), i32.min), i32.max)
    span = (hi - lo) & mask
    if hi <= lo:
        span = 1
    elif out_of_range:
        span = (span + 1) & mask
    k1, k2 = _split2(key)
    higher = _tf.bits(k1, shape, device)
    lower = _tf.bits(k2, shape, device)
    if span == 0:                  # the whole uint32 range: no remainder
        off = lower
    else:
        mult = (((1 << 16) % span) ** 2 & mask) % span
        off = (((higher % span) * mult) & mask) + lower % span
        off = (off & mask) % span
    out = (off + lo) & mask
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def _shuffle_rounds(n):
    """jax's static count of sorting rounds for ``n`` elements."""
    return int(np.ceil(3 * np.log(max(1, n)) /
                       np.log(np.iinfo(np.uint32).max)))


def _shuffle(key, x, axis):
    """``jax.random._shuffle``: each round splits the key and sorts
    ``x`` along ``axis`` by 32-bit draws of x's shape (a stable sort)."""
    for _ in range(_shuffle_rounds(x.numel())):
        key, sub = _split2(key)
        sk = _tf.bits(sub, tuple(x.shape), x.device)
        order = torch.sort(sk, dim=axis, stable=True).indices
        x = torch.gather(x, axis, order)
    return x


def _permutation(key, x, axis=0):
    """``jax.random.permutation(key, x, axis)`` of a torch tensor ``x``
    (1-D: its elements sorted directly; else its slices along ``axis`` in
    the order of a shuffled ``arange``)."""
    if x.dim() == 1:
        return _shuffle(key, x, 0)
    axis = axis % x.dim()
    ind = _shuffle(key, torch.arange(x.shape[axis], device=x.device), 0)
    return torch.index_select(x, axis, ind)


def _categorical(key, logits, shape):
    """``jax.random.categorical(key, logits, axis=-1, shape=shape)``
    (with replacement): the Gumbel noise of ``shape``'s leading dims and
    the logits' shape, added to the logits, argmax over the last axis, as
    int32. The noise is R2's Gumbel fill (within two ulps of jax's)."""
    batch = tuple(logits.shape[:-1])
    shape = tuple(int(s) for s in shape)
    if tuple(np.broadcast_shapes(shape, batch)) != shape:
        raise ValueError(f"categorical: the logits' batch shape {batch} "
                         f"does not broadcast to the shape {shape}")
    prefix = shape[:len(shape) - len(batch)]
    lshape = list(shape[len(shape) - len(batch):]) + [logits.shape[-1]]
    noise = _tf.gumbel(key, (*prefix, *lshape), logits.device)
    expanded = logits.reshape((1,) * len(prefix) + tuple(logits.shape))
    return torch.argmax(noise.to(logits.dtype) + expanded,
                        dim=-1).to(torch.int32)


def _poisson_knuth(key, lam):
    k = torch.zeros(lam.shape, dtype=torch.int64, device=lam.device)
    log_prod = torch.zeros(lam.shape, dtype=torch.float32,
                           device=lam.device)
    rng = key
    while bool((log_prod > -lam).any()):
        rng, sub = _split2(rng)
        k = torch.where(log_prod > -lam, k + 1, k)
        u = _tf.uniform(sub, tuple(lam.shape), lam.device)
        log_prod = log_prod + prng.log_rn(u)
    return k - 1


def _f32(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _poisson_rejection(key, lam):
    fma = prng.fma_f32
    log_lam = prng.log_rn(lam)
    b = fma(_f32(2.53, lam), torch.sqrt(lam.double()).float(),
            _f32(0.931, lam))
    a = fma(_f32(0.02483, lam), b, _f32(-0.059, lam))
    inv_alpha = _f32(1.1239, lam) + _f32(1.1328, lam) / (b - 3.4)
    v_r = _f32(0.9277, lam) - _f32(3.6224, lam) / (b - 2)
    k_out = torch.full(lam.shape, -1.0, dtype=torch.float32,
                       device=lam.device)
    accepted = torch.zeros(lam.shape, dtype=torch.bool, device=lam.device)
    while not bool(accepted.all()):
        keys = prng.split(key, 3)
        key, sk0, sk1 = keys[0], keys[1], keys[2]
        u = _tf.uniform(sk0, tuple(lam.shape), lam.device) - 0.5
        v = _tf.uniform(sk1, tuple(lam.shape), lam.device)
        us = 0.5 - u.abs()
        k = torch.floor(fma(2 * a / us + b, u, lam) + 0.43)
        s = prng.log_rn(v * inv_alpha / (a / (us * us) + b))
        t = fma(k, log_lam, -lam) - torch.lgamma((k + 1).double()).float()
        accept1 = (us >= 0.07) & (v <= v_r)
        reject = (k < 0) | ((us < 0.013) & (v > us))
        accept = accept1 | (~reject & (s <= t))
        k_out = torch.where(accept, k, k_out)
        accepted |= accept
    return k_out.to(torch.int64)


def _poisson(key, lam):
    """``jax.random.poisson(key, lam)`` of f32 ``lam`` as int32: Knuth's
    product of uniforms below 10 (and at NaN), Hormann's transformed
    rejection from 10, both run over every element under the same key
    (the rejection loop runs until every element, the stand-ins included,
    accepted once, and a later acceptance replaces an earlier one, as
    jax's does); 0 where ``lam`` is 0. Logs and lgamma in f64."""
    lam = lam.float()
    knuth = torch.isnan(lam) | (lam < 10)
    lk = torch.where(knuth, lam, torch.zeros_like(lam))
    lr = torch.where(knuth, torch.full_like(lam, 1e5), lam)
    out = torch.where(knuth, _poisson_knuth(key, lk),
                      _poisson_rejection(key, lr))
    return torch.where(lam == 0, torch.zeros_like(out), out).to(torch.int32)


# -- the ops

def _dt(dtype, default=None):
    d = canonical(convert_dtype(dtype)) if dtype is not None else None
    return d or default


def _shape(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(unwrap(s)) for s in shape)


def _float(dtype):
    if dtype.is_floating_point:
        return dtype
    raise TypeError(f"the random draw needs a floating dtype, got {dtype}")


def rand(shape, dtype="float32"):
    return wrap(_tf.uniform(rnd.next_key(), _shape(shape), default_device(),
                            dtype=_float(_dt(dtype))))


def randn(shape, dtype="float32"):
    return wrap(_tf.normal(rnd.next_key(), _shape(shape), default_device(),
                           _float(_dt(dtype))))


def uniform(shape, dtype="float32", min=-1.0, max=1.0, seed=0):  # noqa: A002
    key = prng.PRNGKey(seed) if seed else rnd.next_key()
    return wrap(_tf.uniform(key, _shape(shape), default_device(), min, max,
                            _float(_dt(dtype))))


def _scaled(mean, std, n):
    """``mean + std * n``: two operations rounded in n's type, as the
    reference's eager jnp (weakly typed Python numbers)."""
    if not torch.is_tensor(std):
        std = torch.tensor(std, dtype=n.dtype, device=n.device)
    if not torch.is_tensor(mean):
        mean = torch.tensor(mean, dtype=n.dtype, device=n.device)
    return mean + std * n


def normal(mean=0.0, std=1.0, shape=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m = unwrap(mean)
        s = unwrap(std)
        dev = (m if torch.is_tensor(m) else s).device
        shp = torch.broadcast_shapes(*(tuple(v.shape) if torch.is_tensor(v)
                                       else () for v in (m, s)))
        n = _tf.normal(rnd.next_key(), shp, dev)
        return wrap(_scaled(m, s, n))
    n = _tf.normal(rnd.next_key(), _shape(shape or ()), default_device())
    return wrap(_scaled(mean, std, n))


def gaussian(shape, mean=0.0, std=1.0, dtype="float32"):
    n = _tf.normal(rnd.next_key(), _shape(shape), default_device(),
                   _float(_dt(dtype)))
    return wrap(_scaled(mean, std, n))


def randint(low=0, high=None, shape=(1,), dtype="int64"):
    if high is None:
        low, high = 0, low
    _check_int(_dt(dtype))
    return wrap(_randint(rnd.next_key(), _shape(shape), int(low), int(high),
                         default_device()))


def _check_int(dtype):
    if dtype.is_floating_point or dtype.is_complex or dtype == torch.bool:
        raise TypeError(f"randint only accepts integer dtypes, got {dtype}")
    if dtype != torch.int32:
        raise TypeError(f"randint draws int32 here (64-bit types are "
                        f"narrowed), got {dtype}")


def randint_like(x, low=0, high=None, dtype=None):
    v = unwrap(x)
    if high is None:
        low, high = 0, low
    _check_int(_dt(dtype, v.dtype))
    return wrap(_randint(rnd.next_key(), tuple(v.shape), int(low), int(high),
                         v.device))


def randperm(n, dtype="int64"):
    perm = _permutation(
        rnd.next_key(), torch.arange(int(n), dtype=torch.int32,
                                     device=default_device()))
    return wrap(perm.to(_dt(dtype)))


def shuffle(x, axis=0):
    v = unwrap(x)
    return wrap(_permutation(rnd.next_key(), v, axis=axis))


def multinomial(x, num_samples=1, replacement=False):
    v = unwrap(x)
    logits = prng.log_rn(v + 1e-30)
    if replacement:
        out = _categorical(rnd.next_key(), logits,
                           tuple(v.shape[:-1]) + (num_samples,))
    else:
        # the Gumbel top-k trick, without replacement
        g = _tf.gumbel(rnd.next_key(), tuple(v.shape), v.device)
        out = torch.argsort(logits + g, dim=-1, descending=True,
                            stable=True)[..., :num_samples]
    return wrap(out.to(torch.int32))


def bernoulli(x):
    v = unwrap(x)
    u = _tf.uniform(rnd.next_key(), tuple(v.shape), v.device,
                    dtype=_float(v.dtype))
    return wrap((u < v).to(v.dtype))


def poisson(x):
    v = unwrap(x)
    return wrap(_poisson(rnd.next_key(), v).to(v.dtype))


def exponential_(x, lam=1.0):
    """In place: ``x``'s value becomes ``exponential(key) / lam`` in x's
    type; the draw is f32, as the reference's."""
    v = unwrap(x)
    e = prng.exponential_from_uniform(
        _tf.uniform(rnd.next_key(), tuple(v.shape), v.device))
    x._replace_value((e / torch.tensor(lam, dtype=torch.float32,
                                       device=e.device)).to(v.dtype))
    return x


def uniform_(x, min=-1.0, max=1.0, seed=0):  # noqa: A002
    """In place: ``x``'s value becomes ``uniform(key, min, max)`` in x's
    floating type (f32 for another type); ``seed`` is accepted and not
    used, as in the reference."""
    v = unwrap(x)
    dt = v.dtype if v.is_floating_point() else torch.float32
    x._replace_value(_tf.uniform(rnd.next_key(), tuple(v.shape), v.device,
                                 min, max, dt))
    return x


def standard_normal(shape, dtype="float32"):
    return wrap(_tf.normal(rnd.next_key(), _shape(shape), default_device(),
                           _float(_dt(dtype))))


def rand_like(x, dtype=None):
    v = unwrap(x)
    return wrap(_tf.uniform(rnd.next_key(), tuple(v.shape), v.device,
                            dtype=_float(_dt(dtype, v.dtype))))


def randn_like(x, dtype=None):
    v = unwrap(x)
    return wrap(_tf.normal(rnd.next_key(), tuple(v.shape), v.device,
                           _float(_dt(dtype, v.dtype))))


for _n in ["rand", "randn", "uniform", "normal", "gaussian", "randint",
           "randint_like", "randperm", "shuffle", "multinomial", "bernoulli",
           "poisson", "standard_normal", "rand_like", "randn_like"]:
    register_direct(_n, globals()[_n])
