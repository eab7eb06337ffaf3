"""``jax.random``'s element-wise draws and dropout on one stream (R2): the
CUDA kernel and its plain versions.

Counterpart of the draws the JAX package's functional ops take from
``jax.random`` (jnp, no ``pallas_call``), each over ``shape`` under one
key: ``keep_mask`` (bernoulli's ``uniform < p``, alpha_dropout's mask),
``gumbel`` (``-log(-log(uniform(minval, 1)))``, gumbel_softmax's noise,
the logs in f64 as ``core.prng.log_rn``); and ``dropout``, the keep mask
over a mask shape that broadcasts against the value, applied in the
value's type, forward or backward, the mask drawn again from the key in
both (``paddle_tpu/nn/functional.py:208-228``).

Keys are ``uint32 [2]`` tensors (``core.random.next_key``); the kernel
takes their two words as arguments. The draws that make a tensor take a
``device``: CUDA launches ``csrc/threefry_fill.cu``, the CPU runs the
plain version (built from ``core.prng``); ``dropout`` follows its
value's device. A CUDA request the kernel cannot take raises.
``fill.launches`` counts the draws' launches, ``dropout.launches``
dropout's. Kernel and plain version agree bit for bit (masks, Gumbel
noise and dropout's values).
"""
import ctypes

import torch

from ...core import prng
from . import _build

__all__ = ["gumbel", "keep_mask", "dropout", "fill", "MAX_RANK"]

MAX_RANK = 8                # csrc/threefry_fill.cu: kMaxRank
_KEEP, _GUMBEL = 0, 1
_SCALE, _MASK, _SCALE_GRAD = 0, 1, 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I, _L, _F, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float, ctypes.c_uint32)


def _words(key):
    k0, k1 = (int(w) for w in torch.as_tensor(key).reshape(2).tolist())
    return k0 & prng.MASK, k1 & prng.MASK


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"threefry_fill {what} kernel launch failed: CUDA "
                           f"error {err}")


def _ref_fill(key, shape, what, lo, device):
    """Plain version of ``fill`` on ``device``."""
    k0, k1 = _words(key)
    bits = prng.random_bits(prng.make_key(k0, k1).to(device), shape)
    if what == _KEEP:
        return prng.uniform_from_bits(bits) < torch.tensor(
            lo, dtype=torch.float32, device=device)
    return prng.gumbel_from_bits(bits, lo)


def fill(key, shape, what, device, lo):
    """One draw of ``shape`` under ``key``: ``what`` ``_KEEP`` the keep
    flags ``uniform < lo`` (bool), ``_GUMBEL`` the f32 Gumbel noise
    ``-log(-log(uniform(lo, 1)))``. CUDA launches the kernel, the CPU
    runs the plain version."""
    shape = tuple(int(s) for s in shape)
    device = torch.device(device)
    if device.type != "cuda":
        return _ref_fill(key, shape, what, lo, device)
    k0, k1 = _words(key)
    dtype = torch.uint8 if what == _KEEP else torch.float32
    out = torch.empty(shape, dtype=dtype, device=device)
    fn = _build.function("threefry_fill", "tf_fill_launch",
                         [_U, _U, _I, _P, _L, _F, _P])
    _raise_on(fn(k0, k1, what, out.data_ptr(), out.numel(), float(lo),
                 torch.cuda.current_stream(device).cuda_stream), "fill")
    fill.launches += 1
    return out.view(torch.bool) if what == _KEEP else out


fill.launches = 0


def gumbel(key, shape, device, minval=prng.TINY_F32):
    """``-log(-log(uniform(key, shape, float32, minval, 1)))``: at the
    default ``jax.random.gumbel(key, shape)`` (mode "low"), the logs in
    f64 rounded to f32."""
    return fill(key, shape, _GUMBEL, device, minval)


def keep_mask(key, shape, p, device):
    """``jax.random.bernoulli(key, p, shape)`` for a Python float ``p``:
    ``uniform < f32(p)`` (bool)."""
    return fill(key, shape, _KEEP, device, p)


def _mask_strides(shape, mask_shape):
    """Per axis of ``shape``, the flat-index stride of ``mask_shape`` (0
    where the mask broadcasts)."""
    strides, acc = [], 1
    for s, m in zip(reversed(shape), reversed(mask_shape)):
        strides.append(0 if m == 1 and s != 1 else acc)
        acc *= m
    return strides[::-1]


def _plan(x, mask_shape, p, upscale, backward):
    """(1 - p in f32, 1 - p rounded to x's type, the kernel's mode)."""
    mask_shape = tuple(int(s) for s in mask_shape)
    if len(mask_shape) != x.dim() or any(
            m not in (1, s) for m, s in zip(mask_shape, x.shape)):
        raise ValueError(f"dropout: mask shape {mask_shape} does not "
                         f"broadcast against {tuple(x.shape)}")
    keep_p = 1.0 - p
    c = float(torch.tensor(keep_p, dtype=x.dtype)) if x.dtype in _DTYPES \
        else keep_p
    mode = (_SCALE_GRAD if backward else _SCALE) if upscale else _MASK
    return float(torch.tensor(keep_p, dtype=torch.float32)), c, mode


def _ref_dropout(x, key, mask_shape, p, upscale, backward=False):
    """Plain version of ``dropout`` on x's device: ``where(keep, x / c,
    0)``, ``where(keep, x, 0)`` or ``where(keep, x, 0) / c`` in x's type
    (a true division: the divisor lies on x's device)."""
    keep_p, c, mode = _plan(x, mask_shape, p, upscale, backward)
    keep = _ref_fill(key, tuple(mask_shape), _KEEP, keep_p, x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == _MASK:
        return torch.where(keep, x, zero)
    c_t = torch.tensor(c, dtype=x.dtype, device=x.device)
    if mode == _SCALE:
        return torch.where(keep, x / c_t, zero)
    return torch.where(keep, x, zero) / c_t


def dropout(x, key, mask_shape, p, upscale, backward=False):
    """Dropout of ``x`` under ``key``: keep where ``uniform(mask_shape) <
    1 - p`` (``mask_shape`` is x's shape with 1 on the axes the mask
    broadcasts over); ``upscale``: ``where(keep, x / (1 - p), 0)`` with
    ``1 - p`` rounded to x's type, else ``where(keep, x, 0)``;
    ``backward``: the vjp of the same at gradient ``x``
    (``where(keep, x, 0) / (1 - p)``). CUDA tensors launch the kernel,
    CPU tensors run the plain version."""
    if not x.is_cuda:
        return _ref_dropout(x, key, mask_shape, p, upscale, backward)
    keep_p, c, mode = _plan(x, mask_shape, p, upscale, backward)
    if x.dtype not in _DTYPES:
        raise TypeError(f"dropout takes f32, bf16 or f16 values on the "
                        f"card, got {x.dtype}")
    if x.dim() > MAX_RANK:
        raise ValueError(f"dropout: at most {MAX_RANK} axes on the card, "
                         f"got {x.dim()}")
    mask_shape = tuple(int(s) for s in mask_shape)
    x = x.contiguous()
    out = torch.empty_like(x)
    full = mask_shape == tuple(x.shape)
    rank = 0 if full else x.dim()
    size = (ctypes.c_longlong * MAX_RANK)(*x.shape)
    mstride = (ctypes.c_longlong * MAX_RANK)(
        *(() if full else _mask_strides(tuple(x.shape), mask_shape)))
    fn = _build.function("threefry_fill", "tf_dropout_launch",
                         [_U, _U, _I, _P, _P, _L, _I, _P, _P, _I, _F, _F,
                          _P])
    k0, k1 = _words(key)
    _raise_on(fn(k0, k1, _DTYPES[x.dtype], x.data_ptr(), out.data_ptr(),
                 x.numel(), rank, size, mstride, mode, c, keep_p,
                 torch.cuda.current_stream(x.device).cuda_stream),
              "dropout")
    dropout.launches += 1
    return out


dropout.launches = 0
