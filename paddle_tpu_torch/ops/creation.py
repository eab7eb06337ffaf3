"""Tensor creation ops (paddle.zeros / ones / arange / ... ).

Port of ``paddle_tpu/ops/creation.py``. A new tensor goes to the default
place (the card unless ``set_device`` said otherwise); a ``*_like`` op
keeps its input's device. Dtypes are the reference's: ``arange`` of
integers is int32, of floats float32.
"""
import builtins

import numpy as np
import torch

from ..core.dtype import canonical, convert_dtype
from ..core.tensor import Tensor, dispatch, unwrap, wrap
from ..device import default_device
from .registry import register_direct


def _dt(dtype):
    return canonical(convert_dtype(dtype))


def _shape(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(unwrap(s)) for s in shape)


def _scalar(v):
    v = unwrap(v)
    return v.item() if isinstance(v, torch.Tensor) else v


def zeros(shape, dtype="float32"):
    return wrap(torch.zeros(_shape(shape), dtype=_dt(dtype),
                            device=default_device()))


def ones(shape, dtype="float32"):
    return wrap(torch.ones(_shape(shape), dtype=_dt(dtype),
                           device=default_device()))


def full(shape, fill_value, dtype="float32"):
    return wrap(torch.full(_shape(shape), _scalar(fill_value),
                           dtype=_dt(dtype), device=default_device()))


def empty(shape, dtype="float32"):
    return zeros(shape, dtype)


def _like(x, dtype):
    """(shape, dtype, device) of a ``*_like`` op's output: ``x``'s, or the
    default place for a static Variable's meta value (the constant is
    then a literal of the program, as in the reference)."""
    v = unwrap(x)
    dev = default_device() if v.device.type == "meta" else v.device
    return v.shape, _dt(dtype) or v.dtype, dev


def zeros_like(x, dtype=None):
    shape, dt, dev = _like(x, dtype)
    return wrap(torch.zeros(shape, dtype=dt, device=dev))


def ones_like(x, dtype=None):
    shape, dt, dev = _like(x, dtype)
    return wrap(torch.ones(shape, dtype=dt, device=dev))


def full_like(x, fill_value, dtype=None):
    shape, dt, dev = _like(x, dtype)
    return wrap(torch.full(shape, _scalar(fill_value), dtype=dt, device=dev))


def empty_like(x, dtype=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        is_float = builtins.any(isinstance(v, (float, np.floating))
                                for v in (start, end, step))
        dtype = torch.float32 if is_float else torch.int32
    return wrap(torch.arange(start, end, step, dtype=_dt(dtype),
                             device=default_device()))


def linspace(start, stop, num, dtype=None):
    return wrap(torch.linspace(_scalar(start), _scalar(stop), int(num),
                               dtype=_dt(dtype) or torch.float32,
                               device=default_device()))


def logspace(start, stop, num, base=10.0, dtype=None):
    return wrap(torch.logspace(_scalar(start), _scalar(stop), int(num),
                               base=base, dtype=_dt(dtype) or torch.float32,
                               device=default_device()))


def eye(num_rows, num_columns=None, dtype="float32"):
    m = num_rows if num_columns is None else num_columns
    return wrap(torch.eye(num_rows, m, dtype=_dt(dtype),
                          device=default_device()))


def tril_indices(row, col, offset=0):
    return wrap(torch.tril_indices(row, col, offset,
                                   device=default_device()).to(torch.int32))


def triu_indices(row, col=None, offset=0):
    return wrap(torch.triu_indices(row, col if col else row, offset,
                                   device=default_device()).to(torch.int32))


def clone(x):
    return dispatch(torch.clone, x, name="clone")


def assign(x, output=None):
    v = (unwrap(x) if isinstance(x, Tensor) else Tensor(x)._value).detach()
    if output is not None:
        output._replace_value(v)
        return output
    return wrap(v)


def complex(real, imag):  # noqa: A001
    return dispatch(torch.complex, real, imag, name="complex")


for _n in ["zeros", "ones", "full", "empty", "zeros_like", "ones_like",
           "full_like", "empty_like", "arange", "linspace", "logspace", "eye",
           "tril_indices", "triu_indices", "clone", "assign", "complex"]:
    register_direct(_n, globals()[_n])
