"""Elementwise math, reductions, comparison and logic ops.

Port of ``paddle_tpu/ops/math.py``: each op is the torch expression of
the reference's jnp one, with the reference's dtypes (an integer sum is
int32, an integer mean float32) and its gradients where torch's rule
differs: ``clip`` is ``minimum(maximum(x, min), max)`` (half the
gradient at a bound, as ``jnp.clip``), reductions to an extreme split
the gradient among ties (``amax`` / ``amin``), and ``median`` is the
midpoint of the stable sort's middle pair, as ``jnp.median`` is. A
Python number meets a tensor as JAX's weakly typed constant: it takes
the tensor's type (a float one meets an integer tensor as float32).
"""
import builtins

import numpy as np
import torch

from ..core.dtype import canonical, convert_dtype
from ..core.tensor import as_value
from .registry import register

# ------------------------------------------------------------------ helpers


def scalar_like(s, like):
    """The Python or numpy number ``s`` as a 0-d tensor on ``like``'s
    device, typed as JAX's weak constant beside ``like``."""
    if isinstance(s, torch.Tensor):
        return s
    if isinstance(s, np.ndarray):
        return as_value(s, device=like.device)
    kind = like.dtype
    if isinstance(s, (bool, np.bool_)):
        dt = kind
    elif isinstance(s, (int, np.integer)):
        dt = torch.int32 if kind == torch.bool else kind
    elif isinstance(s, (float, np.floating)):
        dt = kind if (kind.is_floating_point or kind.is_complex) \
            else torch.float32
    else:
        dt = kind if kind.is_complex else torch.complex64
    return torch.tensor(s, dtype=dt, device=like.device)


def pair(x, y):
    """``x`` and ``y`` as tensors (a number takes the other's type)."""
    if isinstance(x, torch.Tensor):
        return x, scalar_like(y, x)
    if isinstance(y, torch.Tensor):
        return scalar_like(x, y), y
    return torch.as_tensor(x), torch.as_tensor(y)


def dims(x, axis):
    """A paddle ``axis`` (None, an int, a list) as torch's ``dim``: a
    tuple of every axis for None."""
    if axis is None:
        return tuple(range(x.dim()))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def as_float(x):
    """Integers and bool as float32, as jnp promotes them for a float op."""
    return x if (x.is_floating_point() or x.is_complex()) \
        else x.to(torch.float32)


def _cdt(dtype):
    return canonical(convert_dtype(dtype))


# ---------------------------------------------------------------- elementwise


def arith(fn, x, y):
    """``fn(x, y)`` with a Python number on either side: torch's own
    scalar rules are JAX's weak typing here (after the canonical
    narrowing), and need no tensor made for the number."""
    if not isinstance(x, torch.Tensor):
        x = scalar_like(x, y)
    return fn(x, y)


@register("add", method=True)
def add(x, y):
    return arith(torch.add, x, y)


@register("subtract", method=True)
def subtract(x, y):
    return arith(torch.subtract, x, y)


@register("multiply", method=True)
def multiply(x, y):
    return arith(torch.multiply, x, y)


@register("divide", method=True)
def divide(x, y):
    return arith(torch.true_divide, x, y)


@register("floor_divide", method=True)
def floor_divide(x, y):
    # the gradient is 0 everywhere (jnp rounds); torch defines none
    return arith(torch.floor_divide, _detached(x), _detached(y))


def _detached(v):
    return v.detach() if isinstance(v, torch.Tensor) else v


@register("mod", method=True)
def mod(x, y):
    return arith(torch.remainder, x, y)


@register("remainder", method=True)
def remainder(x, y):
    return arith(torch.remainder, x, y)


@register("pow", method=True)
def pow(x, y):  # noqa: A001
    if isinstance(x, torch.Tensor) and isinstance(y, (int, np.integer)) \
            and not isinstance(y, bool):
        return torch.pow(x, int(y))      # jnp's integer_pow
    return torch.pow(*pair(x, y))


@register("maximum", method=True)
def maximum(x, y):
    return torch.maximum(*pair(x, y))


@register("minimum", method=True)
def minimum(x, y):
    return torch.minimum(*pair(x, y))


@register("fmax")
def fmax(x, y):
    return torch.fmax(*pair(x, y))


@register("fmin")
def fmin(x, y):
    return torch.fmin(*pair(x, y))


@register("neg", method=True)
def neg(x):
    return torch.neg(x)


class _Abs(torch.autograd.Function):
    """|x| with jnp's gradient: +1 at 0 (``x >= 0``), where torch's
    is 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def jabs(x):
    """``jnp.abs``: torch's values, jnp's gradient at 0 for real
    floating x."""
    if x.is_floating_point() and x.requires_grad:
        return _Abs.apply(x)
    return torch.abs(x)


@register("abs", method=True)
def abs(x):  # noqa: A001
    return jabs(x)


@register("sign", method=True)
def sign(x):
    return torch.sign(x)


def _unary(name, fn, method=True, floats=True):
    def op(x):
        return fn(as_float(x) if floats else x)
    op.__name__ = name
    return register(name, method=method)(op)


for _name, _fn in (("exp", torch.exp), ("expm1", torch.expm1),
                   ("log", torch.log), ("log2", torch.log2),
                   ("log10", torch.log10), ("log1p", torch.log1p),
                   ("sqrt", torch.sqrt), ("rsqrt", torch.rsqrt),
                   ("sin", torch.sin), ("cos", torch.cos),
                   ("tan", torch.tan), ("asin", torch.asin),
                   ("acos", torch.acos), ("atan", torch.atan),
                   ("sinh", torch.sinh), ("cosh", torch.cosh),
                   ("tanh", torch.tanh), ("asinh", torch.asinh),
                   ("acosh", torch.acosh), ("atanh", torch.atanh),
                   ("erf", torch.erf), ("erfinv", torch.erfinv),
                   ("reciprocal", torch.reciprocal)):
    globals()[_name] = _unary(_name, _fn)
_unary("sigmoid", torch.sigmoid, method=False)
_unary("logsigmoid", torch.nn.functional.logsigmoid, method=False)
for _name, _fn in (("square", torch.square), ("floor", torch.floor),
                   ("ceil", torch.ceil), ("round", torch.round),
                   ("trunc", torch.trunc)):
    globals()[_name] = _unary(_name, _fn, floats=False)


@register("atan2")
def atan2(x, y):
    x, y = pair(x, y)
    return torch.atan2(as_float(x), as_float(y))


@register("frac", method=True)
def frac(x):
    return x - torch.trunc(x)


@register("clip", method=True)
def clip(x, min=None, max=None):  # noqa: A002
    if min is not None:
        x = torch.maximum(scalar_like(min, x), x)
    if max is not None:
        x = torch.minimum(scalar_like(max, x), x)
    return x


@register("scale", method=True)
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None):
    return x * scale + bias if bias_after_scale else (x + bias) * scale


@register("lerp", method=True)
def lerp(x, y, weight):
    return x + weight * (y - x)


@register("stanh")
def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


@register("multiply_add")
def multiply_add(x, y, z):
    return x * y + z


@register("logit")
def logit(x, eps=None):
    if eps is not None:
        x = clip(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


@register("logaddexp")
def logaddexp(x, y):
    return torch.logaddexp(*pair(x, y))


@register("hypot")
def hypot(x, y):
    return torch.hypot(*pair(x, y))


@register("nan_to_num", method=True)
def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@register("angle")
def angle(x):
    return torch.angle(x)


@register("conj", method=True)
def conj(x):
    return torch.conj_physical(x)


@register("real", method=True)
def real(x):
    return torch.real(x).clone() if x.is_complex() else x.clone()


@register("imag", method=True)
def imag(x):
    return torch.imag(x).clone() if x.is_complex() else torch.zeros_like(x)


@register("digamma")
def digamma(x):
    return torch.digamma(as_float(x))


@register("lgamma")
def lgamma(x):
    return torch.lgamma(as_float(x))


@register("polygamma")
def polygamma(x, n=1):
    return torch.special.polygamma(n, as_float(x))


@register("heaviside")
def heaviside(x, y):
    # jnp's composition: differentiable in y (torch's heaviside is not)
    x, y = pair(x, y)
    dt = torch.promote_types(x.dtype, y.dtype)
    x, y = x.to(dt), y.to(dt)
    zero, one = torch.zeros((), dtype=dt, device=x.device), \
        torch.ones((), dtype=dt, device=x.device)
    return torch.where(x < 0, zero, torch.where(x > 0, one, y))


@register("copysign")
def copysign(x, y):
    return torch.copysign(*pair(x, y))


@register("gcd")
def gcd(x, y):
    return torch.gcd(*pair(x, y))


@register("lcm")
def lcm(x, y):
    return torch.lcm(*pair(x, y))


# ---------------------------------------------------------------- reductions

def _int_sum_dtype(x, dtype):
    if dtype is not None:
        return _cdt(dtype)
    if x.dtype == torch.bool or not (x.is_floating_point() or x.is_complex()):
        return torch.int32 if x.dtype in (torch.bool, torch.int8, torch.int16,
                                          torch.int32, torch.uint8) \
            else x.dtype
    return None


@register("sum", method=True)
def sum(x, axis=None, dtype=None, keepdim=False):  # noqa: A001
    if axis is None and not keepdim:
        return torch.sum(x, dtype=_int_sum_dtype(x, dtype))
    return torch.sum(x, dim=dims(x, axis), keepdim=keepdim,
                     dtype=_int_sum_dtype(x, dtype))


@register("mean", method=True)
def mean(x, axis=None, keepdim=False):
    if axis is None and not keepdim:
        return torch.mean(as_float(x))
    return torch.mean(as_float(x), dim=dims(x, axis), keepdim=keepdim)


@register("max", method=True)
def max(x, axis=None, keepdim=False):  # noqa: A001
    return torch.amax(x, dim=dims(x, axis), keepdim=keepdim)


@register("min", method=True)
def min(x, axis=None, keepdim=False):  # noqa: A001
    return torch.amin(x, dim=dims(x, axis), keepdim=keepdim)


@register("prod", method=True)
def prod(x, axis=None, keepdim=False, dtype=None):
    dt = _int_sum_dtype(x, dtype)
    d = dims(x, axis)
    if isinstance(d, int):
        return torch.prod(x, d, keepdim=keepdim, dtype=dt)
    out = x if dt is None else x.to(dt)
    for a in sorted((a % builtins.max(x.dim(), 1) for a in d),
                    reverse=True):
        out = torch.prod(out, a, keepdim=keepdim)
    return out


@register("std", method=True)
def std(x, axis=None, unbiased=True, keepdim=False):
    return torch.std(as_float(x), dim=dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


@register("var", method=True)
def var(x, axis=None, unbiased=True, keepdim=False):
    return torch.var(as_float(x), dim=dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def _midpoint(x, axis, keepdim, q=0.5):
    """``jnp.quantile(..., method="midpoint")`` over one axis (None: the
    flattened tensor): the mean of the stable sort's entries at floor
    and ceil of ``q * (n - 1)``; the gradient goes to those entries."""
    xs = as_float(x)
    if axis is None:
        xs, ax = xs.reshape(-1), 0
    else:
        ax = axis % builtins.max(xs.dim(), 1)
    srt = torch.sort(xs, dim=ax, stable=True).values
    pos = q * (xs.shape[ax] - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    out = (srt.select(ax, lo) + srt.select(ax, hi)) * 0.5
    if keepdim:
        if axis is None:
            return out.reshape([1] * x.dim())
        out = out.unsqueeze(ax)
    return out


@register("median", method=True)
def median(x, axis=None, keepdim=False):
    return _midpoint(x, axis, keepdim)


@register("nanmean")
def nanmean(x, axis=None, keepdim=False):
    return torch.nanmean(as_float(x), dim=dims(x, axis), keepdim=keepdim)


@register("nansum")
def nansum(x, axis=None, dtype=None, keepdim=False):
    return torch.nansum(x, dim=dims(x, axis), keepdim=keepdim,
                        dtype=_int_sum_dtype(x, dtype))


@register("logsumexp", method=True)
def logsumexp(x, axis=None, keepdim=False):
    return torch.logsumexp(as_float(x), dim=dims(x, axis), keepdim=keepdim)


@register("all", method=True)
def all(x, axis=None, keepdim=False):  # noqa: A001
    return torch.all(x, dim=dims(x, axis), keepdim=keepdim)


@register("any", method=True)
def any(x, axis=None, keepdim=False):  # noqa: A001
    return torch.any(x, dim=dims(x, axis), keepdim=keepdim)


@register("amax")
def amax(x, axis=None, keepdim=False):
    return torch.amax(x, dim=dims(x, axis), keepdim=keepdim)


@register("amin")
def amin(x, axis=None, keepdim=False):
    return torch.amin(x, dim=dims(x, axis), keepdim=keepdim)


@register("count_nonzero")
def count_nonzero(x, axis=None, keepdim=False):
    return torch.sum(x != 0, dim=dims(x, axis), keepdim=keepdim,
                     dtype=torch.int32)


# ---------------------------------------------------------------- cumulative

def _cum_dtype(x):
    return torch.int32 if x.dtype in (torch.bool, torch.int8, torch.int16,
                                      torch.uint8) else None


@register("cumsum", method=True)
def cumsum(x, axis=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, axis, dtype=_cum_dtype(x))


@register("cumprod", method=True)
def cumprod(x, dim=None):
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.cumprod(x, dim, dtype=_cum_dtype(x))


def _cum_extreme(x, axis, is_max):
    """(running extreme values, index of the first element attaining
    it): the reference's associative scan keeps the EARLIEST index on
    ties, and its values' gradient goes to that element."""
    ax = axis % builtins.max(x.dim(), 1)
    run = (torch.cummax if is_max else torch.cummin)(x, ax).values
    n = x.shape[ax]
    shape = [-1 if i == ax else 1 for i in range(x.dim())]
    pos = torch.arange(n, device=x.device).reshape(shape).expand(x.shape)
    prev = torch.cat([run.narrow(ax, 0, 1), run.narrow(ax, 0, n - 1)], ax)
    fresh = (pos == 0) | ((run > prev) if is_max else (run < prev))
    idx = torch.cummax(torch.where(fresh, pos, torch.zeros_like(pos)),
                       ax).values
    return torch.gather(x, ax, idx), idx.to(torch.int32)


@register("cummax")
def cummax(x, axis=None):
    return _cum_extreme(x.reshape(-1) if axis is None else x,
                        0 if axis is None else axis, True)


@register("cummin")
def cummin(x, axis=None):
    return _cum_extreme(x.reshape(-1) if axis is None else x,
                        0 if axis is None else axis, False)


@register("logcumsumexp")
def logcumsumexp(x, axis=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(as_float(x), axis)


# ---------------------------------------------------------------- comparison

def _cmp(name, fn):
    def op(x, y):
        return fn(*pair(x, y))
    op.__name__ = name
    return register(name, method=True)(op)


for _name, _fn in (("equal", torch.eq), ("not_equal", torch.ne),
                   ("greater_than", torch.gt), ("greater_equal", torch.ge),
                   ("less_than", torch.lt), ("less_equal", torch.le),
                   ("logical_and", torch.logical_and),
                   ("logical_or", torch.logical_or),
                   ("logical_xor", torch.logical_xor),
                   ("bitwise_and", torch.bitwise_and),
                   ("bitwise_or", torch.bitwise_or),
                   ("bitwise_xor", torch.bitwise_xor)):
    globals()[_name] = _cmp(_name, _fn)


@register("equal_all")
def equal_all(x, y):
    x, y = pair(x, y)
    same = tuple(x.shape) == tuple(y.shape) and bool(torch.equal(x, y))
    return torch.tensor(same, device=x.device)


def _close_args(x, y):
    x, y = pair(x, y)
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


@register("allclose", method=True)
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    x, y = _close_args(x, y)
    return torch.isclose(x, y, rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all()


@register("isclose", method=True)
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    x, y = _close_args(x, y)
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


@register("isnan", method=True)
def isnan(x):
    return torch.isnan(x)


@register("isinf", method=True)
def isinf(x):
    return torch.isinf(x)


@register("isfinite", method=True)
def isfinite(x):
    return torch.isfinite(x)


@register("logical_not", method=True)
def logical_not(x):
    return torch.logical_not(x)


@register("bitwise_not", method=True)
def bitwise_not(x):
    return torch.bitwise_not(x)


@register("bitwise_left_shift")
def bitwise_left_shift(x, y):
    return torch.bitwise_left_shift(*pair(x, y))


@register("bitwise_right_shift")
def bitwise_right_shift(x, y):
    return torch.bitwise_right_shift(*pair(x, y))


# -------------------------------------------------- special/extra elementwise


@register("deg2rad", method=True)
def deg2rad(x):
    return torch.deg2rad(as_float(x))


@register("rad2deg", method=True)
def rad2deg(x):
    return torch.rad2deg(as_float(x))


@register("xlogy")
def xlogy(x, y):
    return torch.special.xlogy(*pair(x, y))


@register("sgn", method=True)
def sgn(x):
    return torch.sgn(x)


@register("positive")
def positive(x):
    return x.clone()


@register("negative", method=True)
def negative(x):
    return torch.neg(x)


for _name, _fn in (("i0", torch.special.i0), ("i0e", torch.special.i0e),
                   ("i1", torch.special.i1), ("i1e", torch.special.i1e),
                   ("gammaln", torch.special.gammaln)):
    globals()[_name] = _unary(_name, _fn)


def _gammainc(fn):
    def op(x, y):
        # torch has no derivative in the shape parameter: x enters as a
        # constant (ROADMAP Queue 3, "gammainc's gradient in x")
        x, y = pair(x, y)
        return fn(as_float(x).detach(), as_float(y))
    return op


gammainc = register("gammainc", method=True)(_gammainc(torch.special.gammainc))
gammaincc = register("gammaincc", method=True)(
    _gammainc(torch.special.gammaincc))


@register("multigammaln")
def multigammaln(x, p):
    return torch.special.multigammaln(as_float(x), int(p))


@register("nextafter", method=True)
def nextafter(x, y):
    # not differentiable, as in the reference (jnp has no rule for it)
    return torch.nextafter(*pair(_detached(x), _detached(y)))


@register("ldexp", method=True)
def ldexp(x, y):
    x, y = pair(x, y)
    # x * 2**y (exact); torch.ldexp's gradient is 0 for a negative y
    x = as_float(x)
    return x * torch.pow(2.0, y.to(x.dtype))


@register("frexp", method=True)
def frexp(x):
    m, e = torch.frexp(as_float(x))
    return m, e


@register("isposinf", method=True)
def isposinf(x):
    return torch.isposinf(x)


@register("isneginf", method=True)
def isneginf(x):
    return torch.isneginf(x)


@register("isreal", method=True)
def isreal(x):
    return torch.isreal(x)


@register("isin", nondiff_args=(1,))
def isin(x, test_x, assume_unique=False, invert=False):
    x, test_x = pair(x, test_x)
    return torch.isin(x, test_x, invert=invert)


@register("diff", method=True)
def diff(x, n=1, axis=-1, prepend=None, append=None):
    def edge(v):
        # a number or a 0-d tensor: one slice along axis, as jnp's
        if v is None or (isinstance(v, torch.Tensor) and v.dim() > 0):
            return v
        shape = list(x.shape)
        shape[axis] = 1
        return scalar_like(v, x).expand(shape)
    return torch.diff(x, n=n, dim=axis, prepend=edge(prepend),
                      append=edge(append))


@register("trapezoid")
def trapezoid(y, x=None, dx=1.0, axis=-1):
    if x is None:
        return torch.trapezoid(y, dx=dx, dim=axis)
    return torch.trapezoid(y, x, dim=axis)


@register("cumulative_trapezoid")
def cumulative_trapezoid(y, x=None, dx=1.0, axis=-1):
    ya = torch.movedim(y, axis, -1)
    avg = (ya[..., 1:] + ya[..., :-1]) / 2.0
    if x is not None:
        xa = torch.movedim(x, axis, -1) if x.dim() else x
        seg = avg * torch.diff(xa, dim=-1)
    else:
        seg = avg * dx
    return torch.movedim(torch.cumsum(seg, -1), -1, axis)


def _q(q, x):
    return torch.as_tensor(q, dtype=x.dtype, device=x.device)


@register("quantile", method=True)
def quantile(x, q, axis=None, keepdim=False, interpolation="linear"):
    x = as_float(x)
    return torch.quantile(x, _q(q, x), dim=axis, keepdim=keepdim,
                          interpolation=interpolation)


@register("nanquantile", method=True)
def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear"):
    x = as_float(x)
    return torch.nanquantile(x, _q(q, x), dim=axis, keepdim=keepdim,
                             interpolation=interpolation)


@register("nanmedian", method=True)
def nanmedian(x, axis=None, keepdim=False):
    x = as_float(x)
    return torch.nanquantile(x, _q(0.5, x), dim=axis, keepdim=keepdim,
                             interpolation="midpoint")
